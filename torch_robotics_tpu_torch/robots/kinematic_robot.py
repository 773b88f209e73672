"""Generic URDF-backed robot embodiment and the UR10 instance (counterpart
of torch_robotics_tpu/robots/kinematic_robot.py).

A ``KinematicRobot`` turns a compiled ``KinematicModel`` plus a table of
collision links, margins and self-collision pairs into an embodiment whose
collision points are link origins; FK and point Jacobians run through the
lanes chain (``ops/lanes_fk.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..kin import robot_zoo
from ..kin.model import KinematicModel
from .base import RobotAPI, build_object_margins, build_self_collision_pairs

__all__ = ["KinematicRobot", "RobotUR10", "UR10_OBJECT_COLL_LINKS",
           "UR10_OBJECT_COLL_MARGINS", "UR10_SELF_COLL_PAIRS"]


@dataclasses.dataclass(frozen=True)
class KinematicRobot(RobotAPI):
    """A single-kinematic-model robot whose collision points are link
    origins."""
    model: KinematicModel
    q_min: torch.Tensor                 # (d,)
    q_max: torch.Tensor
    object_margins: torch.Tensor        # (P_obj,)
    self_margins: torch.Tensor          # (K,)
    object_coll_idxs: tuple = ()
    self_coll_idxs: tuple = ()
    self_pair_idxs: tuple = ()          # tuple of (i, j) into self points
    name: str = "KinematicRobot"

    @classmethod
    def create(cls, model: KinematicModel,
               object_coll_links: Sequence[str],
               object_coll_margins: Sequence[float],
               self_coll_pairs: Optional[dict] = None,
               self_collision_margin: float = 0.05,
               name: str = "KinematicRobot") -> "KinematicRobot":
        dev = model.device
        name_to_idx = {n: i for i, n in enumerate(model.link_names)}
        object_coll_idxs = tuple(name_to_idx[n] for n in object_coll_links)
        object_margins, _, _ = build_object_margins(
            list(object_coll_margins), len(object_coll_links))
        self_coll_idxs, pair_idxs = (), ()
        self_margins = torch.zeros((0,), dtype=torch.float32, device=dev)
        if self_coll_pairs:
            self_names = []
            for k, v in self_coll_pairs.items():
                self_names.append(k)
                self_names.extend(v)
            self_names = sorted(set(self_names))
            self_coll_idxs = tuple(name_to_idx[n] for n in self_names)
            pairs, margins = build_self_collision_pairs(
                self_names, self_coll_pairs, points_per_link=1,
                margin_robot=self_collision_margin)
            pair_idxs = tuple(map(tuple, pairs.tolist()))
            self_margins = torch.as_tensor(margins, device=dev)
        return cls(model=model,
                   q_min=torch.as_tensor(model.q_lower, device=dev),
                   q_max=torch.as_tensor(model.q_upper, device=dev),
                   object_margins=torch.as_tensor(object_margins, device=dev),
                   self_margins=self_margins,
                   object_coll_idxs=object_coll_idxs,
                   self_coll_idxs=self_coll_idxs, self_pair_idxs=pair_idxs,
                   name=name)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def ws_dim(self) -> int:
        return 3

    def fk_map_collision(self, q):
        """q (..., d) -> (..., n_links, 3) world link positions."""
        from ..ops.lanes_fk import fk_positions_lanes
        return fk_positions_lanes(self.model, q)

    def fk_map_collision_with_jac(self, q):
        """q (..., d) -> (points (..., n_links, 3), J (..., n_links, 3, d)):
        world link positions and their analytic point Jacobians from one
        lanes FK pass."""
        from ..ops.lanes_fk import fk_points_jacobians_lanes
        return fk_points_jacobians_lanes(self.model, q)


UR10_OBJECT_COLL_LINKS = [
    "shoulder_link", "upper_arm_link", "forearm_link",
    "wrist_1_link", "wrist_2_link", "wrist_3_link",
]
UR10_OBJECT_COLL_MARGINS = [0.15, 0.12, 0.1, 0.08, 0.08, 0.08]
UR10_SELF_COLL_PAIRS = {
    "forearm_link": ["base_link"],
    "wrist_1_link": ["base_link", "shoulder_link"],
    "wrist_3_link": ["base_link", "shoulder_link", "upper_arm_link"],
}


def RobotUR10(device="cuda") -> KinematicRobot:
    """UR10 embodiment with a sphere-margin collision model."""
    return KinematicRobot.create(
        robot_zoo.ur10(device=device),
        object_coll_links=UR10_OBJECT_COLL_LINKS,
        object_coll_margins=UR10_OBJECT_COLL_MARGINS,
        self_coll_pairs=UR10_SELF_COLL_PAIRS, name="RobotUR10")
