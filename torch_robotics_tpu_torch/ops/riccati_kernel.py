"""iLQR Riccati sweep and line-search rollout kernels: wrappers and
dispatch.

Counterparts of torch_robotics_tpu/ops/pallas_riccati.py
(``riccati_backward_pallas_factory`` and
``linesearch_rollout_pallas_factory``, the TPU kernels they replace).  The
CUDA source of both is ``csrc/riccati.cu``; its head comment says what
bounds them on the H100 and how its design answers that.  The plain
PyTorch versions are ``solve/riccati_lanes.riccati_backward_lanes`` and
``linesearch_rollout_lanes``.

The factories take the TPU factories' static arguments and return the
sweep / rollout.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises: every input must be contiguous float32 of
the stated shape, the joint count d at most ``MAX_DOF`` and, for the
sweep, the row count P at most ``riccati_p_cap(d)``.  Any batch size B is
taken as it is (a ragged last block is masked, not padded).  The sweep's
launch shape is ``riccati_launch_config(d, P, B)``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..solve.riccati_lanes import (linesearch_rollout_lanes,
                                   riccati_backward_lanes)
from .cuda_build import CudaKernel

__all__ = ["RICCATI_KERNEL", "ROLLOUT_KERNEL", "MAX_DOF",
           "riccati_launch_config", "riccati_p_cap",
           "riccati_backward_kernel_factory",
           "linesearch_rollout_kernel_factory"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
RICCATI_KERNEL = CudaKernel("riccati.cu", {
    "trt_riccati_launch": [_P] * 6 + [_I] * 6 + [_F] * 6 + [_P],
})
ROLLOUT_KERNEL = CudaKernel("riccati.cu", {
    "trt_rollout_launch": [_P] * 7 + [_I] * 4 + [_F] * 2 + [_P],
})
MAX_DOF = 8        # riccati.cu instantiates D = 1..8
_MAX_COMPUTE = 128                     # riccati.cu kMaxCompute
_PRODUCER = 32                         # riccati.cu kProducer
_ROWS = 16                             # riccati.cu kRows
_MAX_STAGES = 2                        # riccati.cu kMaxStages
_MAX_SMEM = 232448                     # bytes of shared memory a block can use
_N_SM = 132                            # the H100's streaming multiprocessors


def _check(args, shapes):
    """Shapes first (every device); then, off the CPU, the kernel's
    device, type and layout demands."""
    for (name, t), shape in zip(args, shapes):
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s must be %s, got %s"
                             % (name, tuple(shape), tuple(t.shape)))
    tensors = [t for _, t in args]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the iLQR sweep inputs must be on one device")
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError("the iLQR kernels take CPU or CUDA tensors")
    for name, t in args:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous float32" % name)
    return True


def _check_dof(d: int):
    if not 1 <= d <= MAX_DOF:
        raise NotImplementedError(
            "the CUDA iLQR kernels take 1 to %d joints, got %d" % (MAX_DOF, d))


def _group(m: int) -> int:
    """Threads per lane: the power of two >= m."""
    g = 2
    while g < m:
        g *= 2
    return g


def _smem_bytes(d: int, P: int, lanes: int, stages: int) -> int:
    """riccati.cu's ``stages * stage_floats(D, P, lanes)`` in bytes: per
    stage, 2 d + 1 column slots of F_t for each lane (P rows rounded up to
    a multiple of 16, padded to 4 more than a multiple of 32), U_t and
    l_t, rounded up to whole 16 bytes."""
    rows = -(-P // _ROWS) * _ROWS
    col = rows + (4 - rows) % 32
    n = (2 * d + 1) * lanes * col + 3 * d * lanes
    return 4 * stages * (-(-n // 4) * 4)


def riccati_p_cap(d: int) -> int:
    """The largest P the sweep takes at d joints: one stage of the fewest
    lanes a block of whole warps holds must fit a block's shared memory."""
    _check_dof(d)
    unit = 32 // _group(2 * d)
    P = max(0, (_MAX_SMEM // 4 - 3 * d * unit) // (2 * d * unit))
    while _smem_bytes(d, P + 1, unit, 1) <= _MAX_SMEM:
        P += 1
    while _smem_bytes(d, P, unit, 1) > _MAX_SMEM:
        P -= 1
    return P


def riccati_launch_config(d: int, P: int, B: int) -> dict:
    """Launch shape of the sweep (``riccati.cu``): a group of ``group``
    threads per lane (the power of two >= 2 d), ``lanes_per_block`` lanes
    per block (whole warps, at most 128 threads, as few as let the grid
    reach every SM, fewer where P's stages would not fit) and one producer
    warp (``threads`` in all), the ring's ``stages`` (2, or 1 at a large
    P), the dynamic shared memory in bytes and the grid.  Raises
    NotImplementedError above ``riccati_p_cap(d)``."""
    _check_dof(d)
    g = _group(2 * d)
    unit = 32 // g
    want = -(-max(B, 1) // _N_SM)
    lanes = min(_MAX_COMPUTE // g, -(-want // unit) * unit)
    for stages in range(_MAX_STAGES, 0, -1):
        n = lanes
        while n > unit and _smem_bytes(d, P, n, stages) > _MAX_SMEM:
            n -= unit
        smem = _smem_bytes(d, P, n, stages)
        if smem <= _MAX_SMEM:
            return dict(group=g, lanes_per_block=n,
                        threads=n * g + _PRODUCER,
                        stages=stages, smem_bytes=smem, grid=-(-B // n))
    raise NotImplementedError(
        "the CUDA Riccati sweep takes at most %d rows P at d = %d (one "
        "stage of F_t for %d lanes in a block's shared memory), got %d"
        % (riccati_p_cap(d), d, unit, P))


def riccati_backward_kernel_factory(d: int, m: int, P: int, T: int,
                                    dt: float, r: float, mu: float,
                                    kg: float):
    """sweep(U_t_l (T, d, B), l_l (T, m, B), Fc_l (T, m, P, B), Vx0 (m, B))
    -> (ks (T, d, B), Ks (T, d, m, B)); ``sweep.plain`` is the plain
    version."""
    if m != 2 * d:
        raise ValueError("the state block m must be 2 d")
    plain = riccati_backward_lanes(d, m, P, T, dt, r, mu, kg)
    sqrt_ru = (r + mu) ** 0.5
    consts = (dt, 0.5 * dt * dt, r, sqrt_ru * sqrt_ru, sqrt_ru, kg ** 0.5)

    def sweep(U_t_l, l_l, Fc_l, Vx0):
        B = Vx0.shape[-1]
        on_card = _check(
            (("U_t_l", U_t_l), ("l_l", l_l), ("Fc_l", Fc_l), ("Vx0", Vx0)),
            ((T, d, B), (T, m, B), (T, m, P, B), (m, B)))
        if not on_card:
            return plain(U_t_l, l_l, Fc_l, Vx0)
        cfg = riccati_launch_config(d, P, B)
        kw = dict(dtype=torch.float32, device=Vx0.device)
        ks = torch.empty((T, d, B), **kw)
        Ks = torch.empty((T, d, m, B), **kw)
        if B == 0 or T == 0:
            return ks, Ks
        with torch.cuda.device(Vx0.device):
            stream = torch.cuda.current_stream().cuda_stream
            RICCATI_KERNEL.launch(
                "trt_riccati_launch", U_t_l.data_ptr(), l_l.data_ptr(),
                Fc_l.data_ptr(), Vx0.data_ptr(), ks.data_ptr(),
                Ks.data_ptr(), P, T, B, d, cfg["lanes_per_block"],
                cfg["stages"], *consts, stream)
        return ks, Ks

    sweep.plain = plain
    return sweep


def linesearch_rollout_kernel_factory(d: int, m: int, T: int, dt: float,
                                      alphas: Sequence[float]):
    """rollout(xs_l (T + 1, m, B), U_t_l (T, d, B), ks (T, d, B),
    Ks (T, d, m, B)) -> (xs_new (A, T, m, B), U_new (A, T, d, B)), the
    states after step 0; ``rollout.plain`` is the plain version."""
    if m != 2 * d:
        raise ValueError("the state block m must be 2 d")
    alphas = tuple(float(a) for a in alphas)
    A = len(alphas)
    plain = linesearch_rollout_lanes(d, m, T, dt, alphas)
    on_device = {}

    def rollout(xs_l, U_t_l, ks, Ks):
        B = xs_l.shape[-1]
        on_card = _check(
            (("xs_l", xs_l), ("U_t_l", U_t_l), ("ks", ks), ("Ks", Ks)),
            ((T + 1, m, B), (T, d, B), (T, d, B), (T, d, m, B)))
        if not on_card:
            return plain(xs_l, U_t_l, ks, Ks)
        _check_dof(d)
        dev = xs_l.device
        if dev not in on_device:
            on_device[dev] = torch.tensor(alphas, dtype=torch.float32,
                                          device=dev)
        kw = dict(dtype=torch.float32, device=dev)
        xs_new = torch.empty((A, T, m, B), **kw)
        U_new = torch.empty((A, T, d, B), **kw)
        if B == 0 or T == 0 or A == 0:
            return xs_new, U_new
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            ROLLOUT_KERNEL.launch(
                "trt_rollout_launch", xs_l.data_ptr(), U_t_l.data_ptr(),
                ks.data_ptr(), Ks.data_ptr(), on_device[dev].data_ptr(),
                xs_new.data_ptr(), U_new.data_ptr(), T, B, A, d, dt,
                0.5 * dt * dt, stream)
        return xs_new, U_new

    rollout.plain = plain
    return rollout
