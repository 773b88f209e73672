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
launch shape is ``riccati_launch_config(d, P, B)``, the rollout's
``rollout_launch_config(d, A, B)``.  Each has two routes: "registers"
(``riccati_kernel<D>`` / ``rollout_kernel<D>``, d <= ``NARROW_MAX_DOF``)
and "shared" (``riccati_wide_kernel`` / ``rollout_wide_kernel``, d up to
``MAX_DOF``; launches count on ``RICCATI_WIDE_KERNEL`` and
``ROLLOUT_WIDE_KERNEL``).  Each route's group width follows from d.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..solve.riccati_lanes import (linesearch_rollout_lanes,
                                   riccati_backward_lanes)
from .cuda_build import CudaKernel

__all__ = ["RICCATI_KERNEL", "ROLLOUT_KERNEL", "RICCATI_WIDE_KERNEL",
           "ROLLOUT_WIDE_KERNEL", "MAX_DOF", "NARROW_MAX_DOF",
           "riccati_launch_config", "riccati_p_cap", "rollout_launch_config",
           "riccati_backward_kernel_factory",
           "linesearch_rollout_kernel_factory"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
RICCATI_KERNEL = CudaKernel("riccati.cu", {
    "trt_riccati_launch": [_P] * 6 + [_I] * 6 + [_F] * 6 + [_P],
})
ROLLOUT_KERNEL = CudaKernel("riccati.cu", {
    "trt_rollout_launch": [_P] * 7 + [_I] * 5 + [_F] * 2 + [_P],
})
RICCATI_WIDE_KERNEL = CudaKernel("riccati.cu", {
    "trt_riccati_wide_launch": [_P] * 6 + [_I] * 7 + [_F] * 6 + [_P],
})
ROLLOUT_WIDE_KERNEL = CudaKernel("riccati.cu", {
    "trt_rollout_wide_launch": [_P] * 7 + [_I] * 7 + [_F] * 2 + [_P],
})
NARROW_MAX_DOF = 8  # riccati.cu instantiates riccati_kernel<D>, D = 1..8
MAX_DOF = 64        # riccati.cu kWideMaxDof: the wide kernels' joints
_WIDE_MIN_GROUP = 32                   # the wide sweep's threads a lane
_WIDE_MAX_COMPUTE = 512                # riccati.cu kWideMaxCompute
_MAX_COMPUTE = 128                     # riccati.cu kMaxCompute
_PRODUCER = 32                         # riccati.cu kProducer
_ROWS = 16                             # riccati.cu kRows
_MAX_STAGES = 2                        # riccati.cu kMaxStages
_MAX_ROLLOUT_THREADS = 1024            # riccati.cu kMaxRolloutThreads
_ROLL_STAGES = 8                       # riccati.cu kRollStages
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


def _f_rows(P: int) -> int:
    """riccati.cu's f_rows: P rounded up to whole passes of 16 rows."""
    return -(-P // _ROWS) * _ROWS


def _smem_bytes(d: int, P: int, lanes: int, stages: int) -> int:
    """riccati.cu's ``stages * stage_floats(D, P, lanes)`` in bytes: per
    stage, 2 d + 1 column slots of F_t for each lane (P rows rounded up to
    a multiple of 16, padded to 4 more than a multiple of 32), U_t and
    l_t, rounded up to whole 16 bytes."""
    rows = _f_rows(P)
    col = rows + (4 - rows) % 32
    n = (2 * d + 1) * lanes * col + 3 * d * lanes
    return 4 * stages * (-(-n // 4) * 4)


def _wide_stride(rows: int) -> int:
    """riccati.cu's wide_stride: rows rounded up to 4 floats, then to 4
    past a multiple of 8."""
    n = -(-rows // 4) * 4
    return n + 4 if n % 8 == 0 else n


def _wide_lane_floats(d: int) -> int:
    """riccati.cu's wide_lane_floats: what a lane keeps across steps (S,
    G = S B, R11, R12 / K, Vx, k, R11 k, 1 / R11[i][i])."""
    m = 2 * d
    n = (m + d) * _wide_stride(m) + d * d + d * m + m + 3 * d
    return -(-n // 4) * 4


def _wide_stage_floats(d: int, P: int, lanes: int) -> int:
    """riccati.cu's wide_stage_floats: F_t, U_t and l_t of ``lanes``."""
    n = 2 * d * lanes * _wide_stride(_f_rows(P)) + 3 * d * lanes
    return -(-n // 4) * 4


def _wide_smem_bytes(d: int, P: int, lanes: int, stages: int) -> int:
    return 4 * (lanes * _wide_lane_floats(d)
                + stages * _wide_stage_floats(d, P, lanes))


def riccati_p_cap(d: int) -> int:
    """The largest P the sweep takes at d joints: one stage of the fewest
    lanes a block holds must fit a block's shared memory (on the shared
    route beside that lane's own region)."""
    _check_dof(d)

    def fits(P):
        if d > NARROW_MAX_DOF:
            return _wide_smem_bytes(d, P, 1, 1) <= _MAX_SMEM
        return _smem_bytes(d, P, 32 // _group(2 * d), 1) <= _MAX_SMEM

    lo, hi = 0, _MAX_SMEM // 4
    while lo < hi:               # the last P that fits; fits(0) holds
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def _p_refusal(d: int, P: int, unit: int) -> NotImplementedError:
    return NotImplementedError(
        "the CUDA Riccati sweep takes at most %d rows P at d = %d (one "
        "stage of F_t for %d lanes in a block's shared memory), got %d"
        % (riccati_p_cap(d), d, unit, P))


def riccati_launch_config(d: int, P: int, B: int) -> dict:
    """Launch shape of the sweep (``riccati.cu``): its ``route``, a group
    of ``group`` threads per lane, ``lanes_per_block`` lanes per block
    (as few as let the grid reach every SM, fewer where P's stages would
    not fit) and one producer warp (``threads`` in all), the ring's
    ``stages`` (2, or 1 at a large P), the dynamic shared memory in bytes
    and the grid.  Route "registers" (d <= NARROW_MAX_DOF): the power of
    two >= 2 d threads a lane, whole warps, at most 128 threads.  Route
    "shared" (past it): 32, 64 or 128 threads a lane (at least the power
    of two >= 2 d), at most 512 a block, beside each lane's own region.
    Raises NotImplementedError above ``riccati_p_cap(d)``."""
    _check_dof(d)
    want = -(-max(B, 1) // _N_SM)
    if d <= NARROW_MAX_DOF:
        g = _group(2 * d)
        unit = 32 // g
        lanes = min(_MAX_COMPUTE // g, -(-want // unit) * unit)
        for stages in range(_MAX_STAGES, 0, -1):
            n = lanes
            while n > unit and _smem_bytes(d, P, n, stages) > _MAX_SMEM:
                n -= unit
            smem = _smem_bytes(d, P, n, stages)
            if smem <= _MAX_SMEM:
                return dict(route="registers", group=g, lanes_per_block=n,
                            threads=n * g + _PRODUCER, stages=stages,
                            smem_bytes=smem, grid=-(-B // n))
        raise _p_refusal(d, P, unit)
    g = max(_WIDE_MIN_GROUP, _group(2 * d))
    lanes = max(1, min(_WIDE_MAX_COMPUTE // g, want))
    for stages in range(_MAX_STAGES, 0, -1):
        n = lanes
        while n > 1 and _wide_smem_bytes(d, P, n, stages) > _MAX_SMEM:
            n -= 1
        smem = _wide_smem_bytes(d, P, n, stages)
        if smem <= _MAX_SMEM:
            return dict(route="shared", group=g, lanes_per_block=n,
                        threads=n * g + _PRODUCER, stages=stages,
                        smem_bytes=smem, grid=-(-B // n))
    raise _p_refusal(d, P, 1)


def rollout_launch_config(d: int, A: int, B: int, lanes=None,
                          align: int = 4) -> dict:
    """Launch shape of the rollout (``riccati.cu``): its ``route``, a group
    of ``group`` threads per (lane, step size) (the power of two >= d),
    ``lanes`` lanes a block with all ``A``
    step sizes, each step's row of them one copy (1, 2 or 4 floats: the
    most that divides B, that the inputs' alignment ``align`` in floats
    allows and whose block fits, unless given), ``threads`` (whole warps),
    the ring's ``stages`` of a step's rows (2 d^2 + 4 d floats a lane), the
    shared memory in bytes and the grid.  Route "registers" (d <=
    NARROW_MAX_DOF): 8 stages.  Route "shared" (past it): as many stages
    as fit, 2 to 8, beside each group's dx (2 d floats).  Raises
    NotImplementedError where the block of one lane (or of the given
    lanes) passes 1024 threads or a block's shared memory, and ValueError
    for lanes that are not 1, 2 or 4, do not divide B or pass
    ``align``."""
    _check_dof(d)
    wide = d > NARROW_MAX_DOF
    g = _group(d) if d > 1 else 1
    rows = 2 * d * d + 4 * d

    def block(n):
        threads = -(-n * A * g // 32) * 32
        if not wide:
            return threads, _ROLL_STAGES, 4 * _ROLL_STAGES * rows * n
        stages = min(_ROLL_STAGES,
                     (_MAX_SMEM // 4 - n * A * 2 * d) // (rows * n))
        return threads, stages, 4 * (stages * rows * n + n * A * 2 * d)

    def fits(n):
        threads, stages, smem = block(n)
        return (threads <= _MAX_ROLLOUT_THREADS and smem <= _MAX_SMEM
                and stages >= 2)

    if lanes is None:
        lanes = next((n for n in (4, 2) if n <= align and B % n == 0
                      and fits(n)), 1)
    if lanes not in (1, 2, 4) or B % lanes or lanes > align:
        raise ValueError("the rollout takes 1, 2 or 4 lanes a block, "
                         "dividing B = %d and at most the inputs' alignment "
                         "of %d floats; got %s" % (B, align, lanes))
    threads, stages, smem = block(lanes)
    if not fits(lanes):
        raise NotImplementedError(
            "the CUDA rollout's block needs %d threads and %d bytes of shared "
            "memory for %d stages (at most %d threads and %d bytes, at least "
            "2 stages)" % (threads, smem, stages, _MAX_ROLLOUT_THREADS,
                           _MAX_SMEM))
    return dict(route="shared" if wide else "registers", group=g,
                lanes_per_block=lanes, threads=threads, stages=stages,
                smem_bytes=smem, grid=B // lanes)


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
        ptrs = (U_t_l.data_ptr(), l_l.data_ptr(), Fc_l.data_ptr(),
                Vx0.data_ptr(), ks.data_ptr(), Ks.data_ptr(), P, T, B, d)
        with torch.cuda.device(Vx0.device):
            stream = torch.cuda.current_stream().cuda_stream
            if cfg["route"] == "registers":
                RICCATI_KERNEL.launch(
                    "trt_riccati_launch", *ptrs, cfg["lanes_per_block"],
                    cfg["stages"], *consts, stream)
            else:
                RICCATI_WIDE_KERNEL.launch(
                    "trt_riccati_wide_launch", *ptrs, cfg["group"],
                    cfg["lanes_per_block"], cfg["stages"], *consts, stream)
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
        # a copy of n lanes wants every input 4 n-byte aligned
        align = 4
        while any(t.data_ptr() % (4 * align) for t in (xs_l, U_t_l, ks, Ks)):
            align //= 2
        cfg = rollout_launch_config(d, A, B, align=align)
        ptrs = (xs_l.data_ptr(), U_t_l.data_ptr(), ks.data_ptr(),
                Ks.data_ptr(), on_device[dev].data_ptr(), xs_new.data_ptr(),
                U_new.data_ptr(), T, B, A, d)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if cfg["route"] == "registers":
                ROLLOUT_KERNEL.launch(
                    "trt_rollout_launch", *ptrs, cfg["lanes_per_block"], dt,
                    0.5 * dt * dt, stream)
            else:
                ROLLOUT_WIDE_KERNEL.launch(
                    "trt_rollout_wide_launch", *ptrs, cfg["group"],
                    cfg["lanes_per_block"], cfg["stages"], dt, 0.5 * dt * dt,
                    stream)
        return xs_new, U_new

    rollout.plain = plain
    return rollout
