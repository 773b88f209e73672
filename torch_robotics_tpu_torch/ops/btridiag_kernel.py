"""Block-tridiagonal sweep kernel: wrapper and dispatch.

Counterpart of torch_robotics_tpu/ops/pallas_btridiag.py
(``solve_lanes_pallas_w``, the W-persisting sweep that ``solve_lanes_auto``
routes m <= 16 to on the TPU).  The CUDA source is ``csrc/btridiag.cu``;
its head comment says what bounds it on the H100 and how its design
answers that.  The plain PyTorch version is
``solve/btridiag_lanes.solve_lanes_core``.

``solve_lanes_w(D, U, b)`` takes D (H, m, m, B), U (H, m, m, 1) shared over
the batch (last block unused) and b (H, m, B) and returns x (H, m, B).  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  A per-batch U raises, as the reference kernels refuse it.
"""
from __future__ import annotations

import ctypes

import torch

from ..solve.btridiag_lanes import solve_lanes_core
from .cuda_build import CudaKernel

__all__ = ["KERNEL", "solve_lanes_w"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("btridiag.cu", {
    "trt_btridiag_w_launch": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _P],
})
_KERNEL_M = (2, 4, 6, 8, 10, 12, 14, 16)   # btridiag.cu instantiations


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


def solve_lanes_w(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve in the lanes layout (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    if D.device.type != "cuda":
        raise ValueError("solve_lanes_w takes CPU or CUDA tensors")
    for name, t in (("D", D), ("U", U), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous float32" % name)
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
