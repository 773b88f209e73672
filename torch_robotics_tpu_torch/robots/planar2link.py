"""Planar 2-link arm with closed-form FK (counterpart of
torch_robotics_tpu/robots/planar2link.py).

Link lengths l1 = 0.2, l2 = 0.4.  The collision points are the three
joint / end-effector positions interpolated to ``object_num_interp`` points
along the arm (10 asked -> 12, three links of 4, ``build_object_margins``).
The arm has no kinematic model and interpolated points, so it has no lanes
terms and no fused kernel in either package: its planning task takes the
generic residuals and the generic GN step (``solve/gpmp2.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from .base import RobotAPI, build_object_margins

__all__ = ["RobotPlanar2Link"]


@dataclasses.dataclass(frozen=True)
class RobotPlanar2Link(RobotAPI):
    q_min: torch.Tensor                 # (2,)
    q_max: torch.Tensor
    object_margins: torch.Tensor        # (object_num_interp,)
    l1: float = 0.2
    l2: float = 0.4
    name: str = "RobotPlanar2Link"
    object_coll_idxs: tuple = (0, 1, 2)
    object_interpolate: bool = True
    object_num_interp: int = 12
    dt: float = 1.0

    @classmethod
    def create(cls, margin=0.01, num_interpolated_points=10, dt=1.0,
               dtype=torch.float32, device="cuda") -> "RobotPlanar2Link":
        dev = resolve_device(device)
        margins, _, num_interp = build_object_margins(
            [margin] * 3, num_interpolated_points)
        eps = 0.01
        lim = torch.as_tensor([[-np.pi, -np.pi + eps], [np.pi, np.pi - eps]],
                              dtype=dtype, device=dev)
        return cls(q_min=lim[0], q_max=lim[1],
                   object_margins=torch.as_tensor(margins, dtype=dtype,
                                                  device=dev),
                   object_num_interp=num_interp, dt=dt)

    @property
    def device(self) -> torch.device:
        return self.q_min.device

    @property
    def ws_dim(self) -> int:
        return 2

    def link_positions(self, q):
        """Closed-form joint / EE positions: q (..., 2) -> (p0, p1, p2),
        each (..., 2).  The angles are taken as (..., 1) slices: a 0-dim
        slice under ``torch.func.jacfwd`` would promote a product with a
        Python float to float64."""
        q1, q12 = self._angles(q)
        p0 = torch.zeros(q.shape[:-1] + (2,), dtype=q.dtype, device=q.device)
        p1 = torch.cat([torch.cos(q1) * self.l1, torch.sin(q1) * self.l1],
                       dim=-1)
        p2 = p1 + torch.cat([torch.cos(q12) * self.l2,
                             torch.sin(q12) * self.l2], dim=-1)
        return p0, p1, p2

    @staticmethod
    def _angles(q):
        q1 = q[..., 0:1]
        return q1, q1 + q[..., 1:2]

    def fk_map_collision(self, q):
        """q (..., 2) -> the three link points (..., 3, 2)."""
        return torch.stack(self.link_positions(q), dim=-2)

    def fk_map_collision_with_jac(self, q):
        """(points (..., 3, 2), closed-form Jacobians (..., 3, 2, 2))."""
        pts = self.fk_map_collision(q)
        q1, q12 = self._angles(q)
        s1 = torch.sin(q1) * self.l1
        c1 = torch.cos(q1) * self.l1
        s12 = torch.sin(q12) * self.l2
        c12 = torch.cos(q12) * self.l2
        zero = torch.zeros_like(s1)
        J0 = torch.cat([zero, zero, zero, zero], dim=-1)
        J1 = torch.cat([-s1, zero, c1, zero], dim=-1)
        J2 = torch.cat([-s1 - s12, -s12, c1 + c12, c12], dim=-1)
        J = torch.stack([J0, J1, J2], dim=-2)
        return pts, J.reshape(J.shape[:-1] + (2, 2))
