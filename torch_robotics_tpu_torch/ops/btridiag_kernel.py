"""Block-tridiagonal sweep kernels: wrappers and dispatch.

Counterparts of torch_robotics_tpu/ops/pallas_btridiag.py:

- ``solve_lanes_w``: the W-persisting sweep (``solve_lanes_pallas_w``)
  that the reference routes m <= 16 to; CUDA source ``csrc/btridiag.cu``.
- ``solve_lanes_cols``: the column sweep for large m
  (``solve_lanes_pallas_cols`` with its trsv backward tail); CUDA source
  ``csrc/btridiag_cols.cu``.
- ``solve_lanes_auto``: the reference's routing (``solve_lanes_auto`` and
  the m > 32 branch of ``gpmp2._gpmp2_step_lanes_impl``): m <= 16 to the
  W-persisting sweep, larger m to the column sweep.

Each CUDA source's head comment says what bounds its kernel on the H100
and how its design answers that.  The plain PyTorch version of both is
``solve/btridiag_lanes.solve_lanes_core``, generic in m.

Each takes D (H, m, m, B), U (H, m, m, 1) shared over the batch (last
block unused) and b (H, m, B) and returns x (H, m, B).  A CPU tensor takes
the plain version; a CUDA tensor launches a kernel or raises.  A per-batch
U raises, as the reference kernels refuse it.
"""
from __future__ import annotations

import ctypes

import torch

from ..solve.btridiag_lanes import solve_lanes_core
from .cuda_build import CudaKernel

__all__ = ["KERNEL", "COLS_KERNEL", "solve_lanes_w", "solve_lanes_cols",
           "solve_lanes_auto"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("btridiag.cu", {
    "trt_btridiag_w_launch": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _P],
})
COLS_KERNEL = CudaKernel("btridiag_cols.cu", {
    "trt_btridiag_cols_launch": [_P, _P, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, _P],
})
_KERNEL_M = (2, 4, 6, 8, 10, 12, 14, 16)   # btridiag.cu instantiations
_COLS_MAX_M = 64                            # btridiag_cols.cu kMaxM
_W_MAX_M = 16     # the reference's _SCALAR_KERNEL_MAX_M: above it, columns


def _check(D, U, b):
    if D.dim() != 4 or D.shape[1] != D.shape[2]:
        raise ValueError("D must be (H, m, m, B), got %s" % (tuple(D.shape),))
    H, m, _, B = D.shape
    if U.dim() != 4 or tuple(U.shape[:3]) != (H, m, m):
        raise ValueError("U must be (H, m, m, 1), got %s" % (tuple(U.shape),))
    if U.shape[3] != 1:
        raise ValueError("per-batch U (last dim %d) is not supported: the "
                         "off-diagonal blocks must be shared over the batch"
                         % U.shape[3])
    if tuple(b.shape) != (H, m, B):
        raise ValueError("b must be (H, m, B) = %s, got %s"
                         % ((H, m, B), tuple(b.shape)))
    if len({D.device, U.device, b.device}) != 1:
        raise ValueError("D, U and b must be on one device")


def _check_cuda(name, D, U, b):
    if D.device.type != "cuda":
        raise ValueError("%s takes CPU or CUDA tensors" % name)
    for key, t in (("D", D), ("U", U), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous float32" % key)


def solve_lanes_w(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve in the lanes layout, m in 2..16 even on
    the card (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    _check_cuda("solve_lanes_w", D, U, b)
    H, m, _, B = D.shape
    if m not in _KERNEL_M:
        raise NotImplementedError(
            "the CUDA sweep takes m in %s, got %d" % (_KERNEL_M, m))
    x = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    if B == 0 or H == 0:
        return x
    Ls = torch.empty((H, m, m, B), dtype=torch.float32, device=D.device)
    Ws = torch.empty_like(Ls)
    ys = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("trt_btridiag_w_launch", D.data_ptr(), U.data_ptr(),
                      b.data_ptr(), x.data_ptr(), Ls.data_ptr(),
                      Ws.data_ptr(), ys.data_ptr(), H, m, B, stream)
    return x


def solve_lanes_cols(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve in the lanes layout through the column
    sweep, m up to 64 on the card (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    _check_cuda("solve_lanes_cols", D, U, b)
    H, m, _, B = D.shape
    if m > _COLS_MAX_M:
        raise NotImplementedError(
            "the CUDA column sweep takes m <= %d, got %d" % (_COLS_MAX_M, m))
    x = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    if B == 0 or H == 0:
        return x
    Ls = torch.empty((B, H, m, m), dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        COLS_KERNEL.launch("trt_btridiag_cols_launch", D.data_ptr(),
                           U.data_ptr(), b.data_ptr(), x.data_ptr(),
                           Ls.data_ptr(), H, m, B, stream)
    return x


def solve_lanes_auto(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """The reference's routing: m <= 16 to the W-persisting sweep, larger m
    to the column sweep; a CPU tensor takes the plain version for every m
    (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    if D.shape[1] <= _W_MAX_M:
        return solve_lanes_w(D, U, b)
    return solve_lanes_cols(D, U, b)
