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
the stated shape, and the joint count d at most ``MAX_DOF``.  Any batch
size B is taken as it is (a ragged last block is masked, not padded).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..solve.riccati_lanes import (linesearch_rollout_lanes,
                                   riccati_backward_lanes)
from .cuda_build import CudaKernel

__all__ = ["RICCATI_KERNEL", "ROLLOUT_KERNEL", "MAX_DOF",
           "riccati_backward_kernel_factory",
           "linesearch_rollout_kernel_factory"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
RICCATI_KERNEL = CudaKernel("riccati.cu", {
    "trt_riccati_launch": [_P] * 7 + [_I] * 4 + [_F] * 6 + [_P],
})
ROLLOUT_KERNEL = CudaKernel("riccati.cu", {
    "trt_rollout_launch": [_P] * 7 + [_I] * 4 + [_F] * 2 + [_P],
})
MAX_DOF = 8        # riccati.cu instantiates D = 1..8


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
        _check_dof(d)
        kw = dict(dtype=torch.float32, device=Vx0.device)
        ks = torch.empty((T, d, B), **kw)
        Ks = torch.empty((T, d, m, B), **kw)
        if B == 0 or T == 0:
            return ks, Ks
        Fw = torch.empty((m, P, B), **kw)
        with torch.cuda.device(Vx0.device):
            stream = torch.cuda.current_stream().cuda_stream
            RICCATI_KERNEL.launch(
                "trt_riccati_launch", U_t_l.data_ptr(), l_l.data_ptr(),
                Fc_l.data_ptr(), Vx0.data_ptr(), ks.data_ptr(),
                Ks.data_ptr(), Fw.data_ptr(), P, T, B, d, *consts, stream)
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
