"""Point-cloud sphere SDF kernel: wrapper and plain version.

Counterpart of torch_robotics_tpu/ops/pallas_sdf.py (``sphere_sdf_pallas``,
the TPU kernel it replaces, and ``sphere_sdf_reference``).  The CUDA source
is ``csrc/sphere_sdf.cu``; its head comment says what bounds the kernel on
the H100 and how its design answers that.

``sphere_sdf_kernel(points (M, 3), centers (S, 3), radii (S,)) -> (M,)``,
min_j ||p_i - c_j|| - r_j.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

__all__ = ["KERNEL", "sphere_sdf_kernel", "sphere_sdf_reference"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("sphere_sdf.cu", {
    "trt_sphere_sdf_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                              _P],
})


def sphere_sdf_reference(points, centers, radii):
    """Plain version: (M, 3), (S, 3), (S,) -> (M,)."""
    d = torch.linalg.vector_norm(points[:, None, :] - centers[None, :, :],
                                 dim=-1)
    return torch.amin(d - radii, dim=-1)


def sphere_sdf_kernel(points: torch.Tensor, centers: torch.Tensor,
                      radii: torch.Tensor):
    """Sphere-cloud SDF of query points (see module doc)."""
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError("points must be (M, 3), got %s"
                         % (tuple(points.shape),))
    S = centers.shape[0]
    if tuple(centers.shape) != (S, 3) or tuple(radii.shape) != (S,):
        raise ValueError("centers must be (S, 3) and radii (S,), got %s, %s"
                         % (tuple(centers.shape), tuple(radii.shape)))
    if len({points.device, centers.device, radii.device}) != 1:
        raise ValueError("points, centers and radii must be on one device")
    if S == 0:
        raise ValueError("the sphere cloud is empty")
    if points.device.type == "cpu":
        return sphere_sdf_reference(points, centers, radii)
    if points.device.type != "cuda":
        raise ValueError("sphere_sdf_kernel takes CPU or CUDA tensors")
    for key, t in (("points", points), ("centers", centers),
                   ("radii", radii)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous float32" % key)
    M = points.shape[0]
    out = torch.empty((M,), dtype=torch.float32, device=points.device)
    if M == 0:
        return out
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("trt_sphere_sdf_launch", points.data_ptr(),
                      centers.data_ptr(), radii.data_ptr(), out.data_ptr(),
                      M, S, stream)
    return out
