"""Multi-robot embodiment: several arms in one configuration space with
mutual-collision costs (counterpart of
torch_robotics_tpu/robots/multi_robot.py).

A ``MultiRobot`` concatenates the member robots' configuration spaces,
places each member at a fixed base pose and exposes:

- object-collision points: the members' object points, with their margins;
- self-collision pairs: each member's own pairs, then a mutual pair for
  every cross-member pair of object points, with margin
  margin_i + margin_j.

The collision layout is the reference's: the members' object sections,
then their self sections.  Pair indices address that full layout, so the
self-point selection is the identity.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from .base import RobotAPI

__all__ = ["MultiRobot"]


def _self_count(r) -> int:
    """Points in a member's self section."""
    return (len(r.self_coll_idxs) + r.grasped_n_points
            if r.self_coll_idxs else 0)


def _apply_base(R_b, t_b, pts):
    """World points R_b p + t_b for points (..., P, 3), as an elementwise
    multiply-reduce (full float32 on every device, like the lanes FK)."""
    return torch.sum(R_b * pts[..., None, :], dim=-1) + t_b


@dataclasses.dataclass(frozen=True)
class MultiRobot(RobotAPI):
    robots: tuple                       # member robots
    base_rots: torch.Tensor             # (n, 3, 3) world base rotations
    base_trans: torch.Tensor            # (n, 3) world base translations
    q_min: torch.Tensor
    q_max: torch.Tensor
    object_margins: torch.Tensor        # members' object margins, in order
    self_margins: torch.Tensor          # own pairs, then mutual pairs
    name: str = "MultiRobot"
    q_dims: tuple = ()
    obj_counts: tuple = ()              # object points per member
    self_counts: tuple = ()             # self points per member
    object_coll_idxs: tuple = ()
    self_coll_idxs: tuple = ()
    self_pair_idxs: tuple = ()

    @classmethod
    def create(cls, robots: Sequence, base_poses: Sequence,
               mutual_collision: bool = True) -> "MultiRobot":
        """robots: member robots (3-D workspace); base_poses: one (R, t)
        per member, each array-like."""
        robots = tuple(robots)
        obj_counts = [int(r.object_margins.shape[0]) for r in robots]
        obj_off = np.cumsum([0] + obj_counts)[:-1]
        self_off = sum(obj_counts) + np.cumsum(
            [0] + [_self_count(r) for r in robots])[:-1]
        pairs, margins = [], []
        for i, r in enumerate(robots):
            if _self_count(r) == 0:
                continue
            pairs.extend((int(self_off[i] + a), int(self_off[i] + b))
                         for a, b in r.self_pair_idxs)
            margins.extend(r.self_margins.cpu().numpy().tolist())
        if mutual_collision:
            for i, j in itertools.combinations(range(len(robots)), 2):
                mi = robots[i].object_margins.cpu().numpy()
                mj = robots[j].object_margins.cpu().numpy()
                for a in range(obj_counts[i]):
                    for b in range(obj_counts[j]):
                        pairs.append((int(obj_off[i] + a),
                                      int(obj_off[j] + b)))
                        margins.append(float(mi[a]) + float(mj[b]))
        return cls.from_pairs(robots, [R for R, _ in base_poses],
                              [t for _, t in base_poses], pairs,
                              np.asarray(margins, np.float64).astype(
                                  np.float32))

    @classmethod
    def from_pairs(cls, robots: Sequence, base_rots, base_trans, pair_idxs,
                   pair_margins) -> "MultiRobot":
        """A MultiRobot with an explicit pair list (K, 2) over the full
        collision layout and its float32 margins (K,); ``create`` builds the
        reference's list."""
        robots = tuple(robots)
        dev = robots[0].device

        def f32(x):
            return torch.as_tensor(np.array(
                x.cpu() if torch.is_tensor(x) else x, np.float32),
                device=dev)

        obj_counts = tuple(int(r.object_margins.shape[0]) for r in robots)
        self_counts = tuple(_self_count(r) for r in robots)
        n_obj = sum(obj_counts)
        return cls(
            robots=robots, base_rots=torch.stack([f32(R) for R in base_rots]),
            base_trans=torch.stack([f32(t) for t in base_trans]),
            q_min=torch.cat([r.q_min for r in robots]),
            q_max=torch.cat([r.q_max for r in robots]),
            object_margins=torch.cat([r.object_margins for r in robots]),
            self_margins=f32(pair_margins).reshape(-1),
            q_dims=tuple(r.q_dim for r in robots), obj_counts=obj_counts,
            self_counts=self_counts,
            object_coll_idxs=tuple(range(n_obj)),
            self_coll_idxs=tuple(range(n_obj + sum(self_counts))),
            self_pair_idxs=tuple((int(a), int(b)) for a, b in
                                 np.asarray(pair_idxs).reshape(-1, 2)))

    @property
    def device(self) -> torch.device:
        return self.robots[0].device

    @property
    def ws_dim(self) -> int:
        return 3

    def _split_q(self, q):
        out, i = [], 0
        for d in self.q_dims:
            out.append(q[..., i:i + d])
            i += d
        return out

    def fk_map_collision(self, q):
        """q (..., sum d_i) -> (..., P_obj_total + P_self_total, 3)."""
        obj_parts, self_parts = [], []
        for i, (r, qi) in enumerate(zip(self.robots, self._split_q(q))):
            pts = r.fk_map_collision(qi)
            R_b, t_b = self.base_rots[i], self.base_trans[i]
            obj_parts.append(_apply_base(R_b, t_b,
                                         r.object_collision_points(pts)))
            if self.self_counts[i] > 0:
                self_parts.append(_apply_base(R_b, t_b,
                                              r.self_collision_points(pts)))
        return torch.cat(obj_parts + self_parts, dim=-2)

    def fk_map_collision_with_jac(self, q):
        """Points and block-diagonal analytic Jacobians:
        q (..., sum d_i) -> ((..., P, 3), (..., P, 3, sum d_i))."""
        d_total = self.q_dim
        obj_pts, obj_jacs, self_pts, self_jacs = [], [], [], []
        offset = 0
        for i, (r, qi) in enumerate(zip(self.robots, self._split_q(q))):
            pts, J = r.fk_map_collision_with_jac(qi)
            R_b, t_b = self.base_rots[i], self.base_trans[i]
            d_i = self.q_dims[i]

            def place(Jsel):
                """Rotate (..., P, 3, d_i) into the world frame and embed
                its columns at this member's offset."""
                Jw = torch.sum(R_b[:, :, None] * Jsel[..., None, :, :],
                               dim=-2)
                return torch.nn.functional.pad(
                    Jw, [offset, d_total - offset - d_i])

            obj_pts.append(_apply_base(R_b, t_b,
                                       r.object_collision_points(pts)))
            obj_jacs.append(place(r.select_collision_jacobians(
                J, r.object_coll_idxs, r.object_interpolate,
                r.object_num_interp)))
            if self.self_counts[i] > 0:
                self_pts.append(_apply_base(R_b, t_b,
                                            r.self_collision_points(pts)))
                self_jacs.append(place(r.select_collision_jacobians(
                    J, r.self_coll_idxs)))
            offset += d_i
        return (torch.cat(obj_pts + self_pts, dim=-2),
                torch.cat(obj_jacs + self_jacs, dim=-3))
