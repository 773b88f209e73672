"""Robot embodiments: configuration space + collision model (counterpart of
torch_robotics_tpu/robots/base.py).

The self-collision pair construction follows the reference: points are
grouped per configured link (``points_per_link`` p), and for each
(link_1 -> link_2) entry of the pairs dict all p x p point pairs are added
with per-pair margins; grasped-object points add pairs against the
configured links.
"""
from __future__ import annotations

import itertools
from math import ceil
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.utils import finite_difference_vector
from ..costs.fields import interpolate_points

__all__ = ["RobotAPI", "build_object_margins", "build_self_collision_pairs"]


def build_object_margins(link_margins: Sequence[float], num_interpolated: int,
                         grasped_n_points: int = 0,
                         grasped_margin: float = 0.001):
    """Per-collision-point margins (float32 numpy) with interpolation and
    grasped-object rows: -> (margins (P,), points_per_link, total points)."""
    n_links = len(link_margins)
    if num_interpolated < n_links:
        raise ValueError("need at least one collision point per link")
    if num_interpolated % n_links != 0:
        per_link = ceil(num_interpolated / n_links)
        num_interpolated = per_link * n_links
    else:
        per_link = num_interpolated // n_links
    margins = np.repeat(np.asarray(link_margins, np.float64), per_link)
    if grasped_n_points > 0:
        margins = np.concatenate(
            [margins, np.full(grasped_n_points, grasped_margin)])
    return margins.astype(np.float32), per_link, num_interpolated


def build_self_collision_pairs(
        link_names: Sequence[str], pairs: dict, points_per_link: int,
        margin_robot: float, grasped_n_points: int = 0,
        grasped_links: Optional[Sequence[str]] = None,
        grasped_margin: float = 0.05):
    """Pair index matrix (K, 2) int32 + margins (K,) float32."""
    p = points_per_link
    idxs = []
    margins = []
    for i, link_1 in enumerate(link_names):
        if link_1 in pairs:
            for link_2 in pairs[link_1]:
                j = link_names.index(link_2)
                for m, n in itertools.product(range(p), range(p)):
                    idxs.append((i * p + m, j * p + n))
                    margins.append(margin_robot)
    if grasped_n_points > 0 and grasped_links:
        base = len(link_names) * p
        for link_1 in grasped_links:
            j = link_names.index(link_1)
            for m, n in itertools.product(range(grasped_n_points), range(p)):
                idxs.append((base + m, j * p + n))
                margins.append(grasped_margin)
    return (np.asarray(idxs, np.int32) if idxs else np.zeros((0, 2), np.int32),
            np.asarray(margins, np.float64).astype(np.float32))


class RobotAPI:
    """Shared robot behaviour: states x = [q, qd, qdd] on the last axis;
    a missing derivative is a central finite difference along the horizon
    axis (-2) at the robot's ``dt``."""
    dt: float = 1.0

    @property
    def q_dim(self) -> int:
        return self.q_min.shape[-1]

    def get_position(self, x):
        return x[..., :self.q_dim]

    def random_q(self, generator: torch.Generator, n_samples: int = 10):
        """Uniform configurations in [q_min, q_max]: (n_samples, q_dim).

        The draw runs on ``generator``'s device and moves to the robot's,
        so one CPU generator gives the same samples for a card run and a
        CPU run."""
        u = torch.rand((n_samples, self.q_dim), generator=generator,
                       dtype=self.q_min.dtype, device=generator.device)
        u = u.to(self.q_min.device)
        return self.q_min + u * (self.q_max - self.q_min)

    def get_velocity(self, x):
        """Velocities of states x (..., H, D): qd where D >= 2 q_dim, else
        the central finite difference of x along H (zero at both ends)."""
        if x.shape[-1] >= 2 * self.q_dim:
            return x[..., self.q_dim:2 * self.q_dim]
        return finite_difference_vector(x, dt=self.dt, method="central")

    def get_acceleration(self, x):
        """Accelerations of states x (..., H, D): qdd where D >= 3 q_dim,
        else the central finite difference of ``get_velocity(x)``."""
        if x.shape[-1] >= 3 * self.q_dim:
            return x[..., 2 * self.q_dim:3 * self.q_dim]
        return finite_difference_vector(self.get_velocity(x), dt=self.dt,
                                        method="central")

    def distance_q(self, q1, q2):
        return torch.linalg.vector_norm(q1 - q2, dim=-1)

    def select_collision_jacobians(self, J_full, idxs, interpolate=False,
                                   num_interp=0):
        """The point selection of the collision-point selectors applied to
        per-point Jacobians J_full (..., P, ws_dim, q_dim): the links
        ``idxs``, linearly interpolated to ``num_interp`` points where
        ``interpolate`` is set (the same map as the points', which is
        linear, so the Jacobians interpolate alike), then the grasped
        points (the last G of J_full)."""
        J = J_full[..., list(idxs), :, :]
        if interpolate:
            P, dim, d = J.shape[-3:]
            J = interpolate_points(J.reshape(J.shape[:-2] + (dim * d,)),
                                   num_interp)
            J = J.reshape(J.shape[:-1] + (dim, d))
        if self.grasped_n_points > 0:
            J = torch.cat([J, J_full[..., -self.grasped_n_points:, :, :]],
                          dim=-3)
        return J

    def object_collision_points(self, link_pos):
        """Select (and interpolate) the object-collision points from FK
        output (..., n_links [+ G], 3), then the grasped points."""
        pts = link_pos[..., list(self.object_coll_idxs), :]
        if self.object_interpolate:
            pts = interpolate_points(pts, self.object_num_interp)
        if self.grasped_n_points > 0:
            pts = torch.cat([pts, link_pos[..., -self.grasped_n_points:, :]],
                            dim=-2)
        return pts

    def self_collision_points(self, link_pos):
        """The self-collision links' points, then the grasped points; None
        for a robot without self-collision links."""
        if not self.self_coll_idxs:
            return None
        pts = link_pos[..., list(self.self_coll_idxs), :]
        if self.grasped_n_points > 0:
            pts = torch.cat([pts, link_pos[..., -self.grasped_n_points:, :]],
                            dim=-2)
        return pts

    # defaults (overridden by concrete robots)
    self_coll_idxs = ()
    self_pair_idxs = ()
    grasped_n_points = 0
    object_interpolate = False
    object_num_interp = 0
