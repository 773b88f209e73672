"""Point-cloud obstacles: large sphere sets behind the sphere-SDF kernel
(counterpart of torch_robotics_tpu/geom/point_cloud.py).

Perceived obstacles (depth-camera point clouds, sphere-decomposed meshes)
become a ``PointCloudSpheres`` field with hundreds to thousands of spheres.
Routing is the reference's: a query goes to the CUDA kernel
(``ops/sdf_kernel.sphere_sdf_kernel``) when ``use_pallas`` is set, the
cloud holds at least 128 spheres and the points are 3-D; otherwise to the
plain PyTorch min over the cloud.  The kernel's wrapper takes its own plain
version for a CPU tensor, so on the CPU both routes compute the same
function.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["PointCloudSpheres"]

_PALLAS_MIN_SPHERES = 128


@dataclasses.dataclass(frozen=True)
class PointCloudSpheres:
    """Sphere cloud: centers (S, 3), radii (S,).  ``use_pallas`` keeps the
    reference's field name: on the card it selects the CUDA kernel."""
    centers: torch.Tensor
    radii: torch.Tensor
    use_pallas: bool = True

    @classmethod
    def create(cls, centers, radius=0.02, dtype=torch.float32,
               use_pallas: bool = True, device="cuda"):
        """centers (S, 3) array-like; radius a scalar shared by the cloud
        or one per sphere (S,)."""
        dev = resolve_device(device)
        centers = torch.as_tensor(np.asarray(centers), dtype=dtype,
                                  device=dev).contiguous()
        radii = torch.as_tensor(np.asarray(radius), dtype=dtype,
                                device=dev).expand(
            centers.shape[:1]).contiguous()
        return cls(centers=centers, radii=radii, use_pallas=use_pallas)

    @property
    def dim(self) -> int:
        return self.centers.shape[-1]

    def signed_distance(self, x):
        """x: (..., 3) -> (...,) min over the cloud."""
        S = self.centers.shape[0]
        flat = x.reshape(-1, x.shape[-1])
        if (self.use_pallas and S >= _PALLAS_MIN_SPHERES
                and x.shape[-1] == 3):
            from ..ops.sdf_kernel import sphere_sdf_kernel
            out = sphere_sdf_kernel(flat.contiguous(), self.centers,
                                    self.radii)
        else:
            d = torch.linalg.vector_norm(flat[:, None, :] - self.centers[None],
                                         dim=-1)
            out = torch.amin(d - self.radii, dim=-1)
        return out.reshape(x.shape[:-1])

    compute_signed_distance = signed_distance
