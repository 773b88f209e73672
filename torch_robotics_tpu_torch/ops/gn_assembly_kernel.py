"""Gauss-Newton assembly from materialized rows: wrapper and dispatch.

Counterpart of torch_robotics_tpu/ops/pallas_gn_assembly.py
(``gn_assembly_pallas``, the TPU kernel it replaces; ``gn_assembly_auto``,
``gn_assembly_reference`` and ``triu_index_pairs`` keep their names).  The
CUDA source is ``csrc/gn_assembly.cu``; its head comment says what bounds
the kernel on the H100 and how its design answers that.  Nothing in either
package routes to it: the fused terms kernels subsume it.

Contract, per lane n:

    g[j]    = sum_p r[p] * Jr[p, j]
    Hu[u]   = sum_p Jr[p, i] * Jr[p, j]   for u = tri(i, j), j >= i
    cost    = 0.5 * sum_p r[p]^2

Scaling by the collision weight is the caller's (fold sqrt(lam) into r and
Jr).  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

__all__ = ["KERNEL", "gn_assembly", "gn_assembly_reference",
           "gn_assembly_auto", "triu_index_pairs"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("gn_assembly.cu", {
    "trt_gn_assembly_launch": [_P, _P, _P, _P, _P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _P],
})
_KERNEL_MAX_D = 8            # gn_assembly.cu instantiates D = 1..8


def triu_index_pairs(d: int):
    """[(i, j)] for the upper triangle in the kernel's row order."""
    return [(i, j) for i in range(d) for j in range(i, d)]


def gn_assembly_reference(r, Jr):
    """Plain PyTorch version: r (P, N), Jr (P, d, N) -> g (d, N), Hu
    (d (d + 1) / 2, N), cost (N,)."""
    d = Jr.shape[1]
    g = torch.sum(r[:, None, :] * Jr, dim=0)
    rows = [torch.sum(Jr[:, i, :] * Jr[:, j, :], dim=0)
            for i, j in triu_index_pairs(d)]
    return g, torch.stack(rows), 0.5 * torch.sum(r * r, dim=0)


def gn_assembly(r: torch.Tensor, Jr: torch.Tensor):
    """r (P, N), Jr (P, d, N) -> (g (d, N), Hu (d (d + 1) / 2, N), cost
    (N,)); d <= 8 on the card (see module doc)."""
    if Jr.dim() != 3 or r.dim() != 2 or tuple(r.shape) != (Jr.shape[0],
                                                          Jr.shape[2]):
        raise ValueError("r must be (P, N) and Jr (P, d, N), got %s and %s"
                         % (tuple(r.shape), tuple(Jr.shape)))
    if r.device != Jr.device:
        raise ValueError("r and Jr must be on one device")
    if r.device.type == "cpu":
        return gn_assembly_reference(r, Jr)
    if r.device.type != "cuda":
        raise ValueError("gn_assembly takes CPU or CUDA tensors")
    for name, t in (("r", r), ("Jr", Jr)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous float32" % name)
    P, d, N = Jr.shape
    if not 1 <= d <= _KERNEL_MAX_D:
        raise NotImplementedError("the CUDA assembly takes 1 <= d <= %d, "
                                  "got %d" % (_KERNEL_MAX_D, d))
    kw = dict(dtype=torch.float32, device=r.device)
    g = torch.empty((d, N), **kw)
    hu = torch.empty((d * (d + 1) // 2, N), **kw)
    cost = torch.empty((N,), **kw)
    if N == 0:
        return g, hu, cost
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("trt_gn_assembly_launch", r.data_ptr(), Jr.data_ptr(),
                      g.data_ptr(), hu.data_ptr(), cost.data_ptr(), P, d, N,
                      stream)
    return g, hu, cost


# the reference's name for its dispatching entry (kernel on its chip, plain
# version elsewhere), which ``gn_assembly`` already is
gn_assembly_auto = gn_assembly
