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
    """Shared robot behaviour: states x = [q, qd, ...] on the last axis."""

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
        """Velocities of states x = [q, qd, ...] (x.shape[-1] >= 2 q_dim);
        the finite-difference branch for position-only inputs is not
        ported yet."""
        if x.shape[-1] < 2 * self.q_dim:
            raise NotImplementedError(
                "finite-difference velocities are not ported yet")
        return x[..., self.q_dim:2 * self.q_dim]

    def distance_q(self, q1, q2):
        return torch.linalg.vector_norm(q1 - q2, dim=-1)

    def select_collision_jacobians(self, J_full, idxs, interpolate=False,
                                   num_interp=0):
        """The point selection of the collision-point selectors applied to
        per-point Jacobians J_full (..., P, ws_dim, q_dim).  Interpolated
        points and grasped-object points are not ported and raise."""
        if interpolate:
            raise NotImplementedError(
                "interpolated collision points are not ported yet")
        if self.grasped_n_points > 0:
            raise NotImplementedError(
                "grasped-object collision points are not ported yet")
        return J_full[..., list(idxs), :, :]

    def object_collision_points(self, link_pos):
        """Select (and interpolate) the object-collision points from FK
        output (..., n_links, 3)."""
        pts = link_pos[..., list(self.object_coll_idxs), :]
        if self.object_interpolate:
            pts = interpolate_points(pts, self.object_num_interp)
        return pts

    def self_collision_points(self, link_pos):
        if not self.self_coll_idxs:
            return None
        return link_pos[..., list(self.self_coll_idxs), :]

    # defaults (overridden by concrete robots)
    self_coll_idxs = ()
    self_pair_idxs = ()
    grasped_n_points = 0
    object_interpolate = False
    object_num_interp = 0
