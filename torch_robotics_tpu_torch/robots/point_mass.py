"""Point-mass robots (2-D / 3-D) with identity FK (counterpart of
torch_robotics_tpu/robots/point_mass.py).

The configuration is the position: one collision point per configuration,
its Jacobian the identity, workspace dimension = configuration dimension,
no self-collision pairs.  The point mass has no fused terms kernel (in the
JAX package neither): its planning task takes the plain lanes terms of
``ops/lanes_fk.py`` on every device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from .base import RobotAPI

__all__ = ["RobotPointMass", "RobotPointMass3D"]


@dataclasses.dataclass(frozen=True)
class RobotPointMass(RobotAPI):
    q_min: torch.Tensor                 # (d,)
    q_max: torch.Tensor
    object_margins: torch.Tensor        # (1,)
    name: str = "RobotPointMass"
    object_coll_idxs: tuple = (0,)
    dt: float = 1.0

    @classmethod
    def create(cls, q_limits=((-1.0, -1.0), (1.0, 1.0)), margin=0.01,
               dt=1.0, name="RobotPointMass", dtype=torch.float32,
               device="cuda") -> "RobotPointMass":
        dev = resolve_device(device)
        lim = torch.as_tensor(np.asarray(q_limits, np.float64), dtype=dtype,
                              device=dev)
        return cls(q_min=lim[0], q_max=lim[1],
                   object_margins=torch.tensor([margin], dtype=dtype,
                                               device=dev),
                   name=name, dt=dt)

    @property
    def device(self) -> torch.device:
        return self.q_min.device

    @property
    def ws_dim(self) -> int:
        return self.q_dim

    def fk_map_collision(self, q):
        """Identity FK: q (..., d) -> one point (..., 1, d)."""
        return q[..., None, :]

    def fk_map_collision_with_jac(self, q):
        """(points (..., 1, d), Jacobians (..., 1, d, d) = identity)."""
        d = self.q_dim
        J = torch.eye(d, dtype=q.dtype, device=q.device).expand(
            q.shape[:-1] + (1, d, d))
        return q[..., None, :], J


def RobotPointMass3D(margin=0.01, dt=1.0, dtype=torch.float32,
                     device="cuda") -> RobotPointMass:
    return RobotPointMass.create(
        q_limits=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)), margin=margin, dt=dt,
        name="RobotPointMass3D", dtype=dtype, device=device)
