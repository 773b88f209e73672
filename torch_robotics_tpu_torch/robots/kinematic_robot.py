"""Generic URDF-backed robot embodiment and the UR10 instance (counterpart
of torch_robotics_tpu/robots/kinematic_robot.py).

A ``KinematicRobot`` turns a compiled ``KinematicModel`` plus a table of
collision links, margins and self-collision pairs into an embodiment whose
collision points are link origins, followed, for a robot that holds a
grasped object, by the object's points fixed in the frame of its link; FK
and point Jacobians run through the lanes chain (``ops/lanes_fk.py``).
Its end effector is the link ``link_name_ee`` (the EE-pose goal factor
and the accessors ``get_EE_*`` read it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core.se3 import link_quat_from_link_tensor
from ..kin import robot_zoo
from ..kin.fk import fk_all_links
from ..kin.model import KinematicModel
from .base import RobotAPI, build_object_margins, build_self_collision_pairs

__all__ = ["KinematicRobot", "RobotUR10", "UR10_OBJECT_COLL_LINKS",
           "UR10_OBJECT_COLL_MARGINS", "UR10_SELF_COLL_PAIRS"]


@dataclasses.dataclass(frozen=True)
class KinematicRobot(RobotAPI):
    """A single-kinematic-model robot whose collision points are link
    origins, and the ``grasped_n_points`` points ``grasped_points`` (G, 3)
    fixed in the frame of link ``link_name_grasped_object``."""
    model: KinematicModel
    q_min: torch.Tensor                 # (d,)
    q_max: torch.Tensor
    object_margins: torch.Tensor        # (P_obj,)
    self_margins: torch.Tensor          # (K,)
    object_coll_idxs: tuple = ()
    self_coll_idxs: tuple = ()
    self_pair_idxs: tuple = ()          # tuple of (i, j) into self points
    # learned self-collision SDF (costs.SelfCollisionNet): when set, its one
    # row per waypoint replaces the self-collision pair rows
    self_collision_net: object = None
    name: str = "KinematicRobot"
    # a grasped object's points (G, 3) in the frame of its link, or None
    grasped_points: Optional[torch.Tensor] = None
    link_name_grasped_object: str = "grasped_object"
    link_name_ee: str = "ee_link"

    @classmethod
    def create(cls, model: KinematicModel,
               object_coll_links: Sequence[str],
               object_coll_margins: Sequence[float],
               self_coll_pairs: Optional[dict] = None,
               self_collision_margin: float = 0.05,
               link_name_ee: str = "ee_link",
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
                   link_name_ee=link_name_ee, name=name)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def ws_dim(self) -> int:
        return 3

    @property
    def grasped_n_points(self) -> int:
        g = self.grasped_points
        return 0 if g is None else g.shape[0]

    def grasped_extra_points(self):
        """[(link, (3,) point in its frame), ...] of the grasped points
        (empty without a grasped object)."""
        if self.grasped_n_points == 0:
            return []
        gi = self.model.link_index(self.link_name_grasped_object)
        return [(gi, self.grasped_points[g])
                for g in range(self.grasped_n_points)]

    def fk_map_collision(self, q):
        """q (..., d) -> (..., n_links [+ G], 3) world link positions, then
        the grasped points."""
        from ..ops.lanes_fk import fk_positions_lanes
        return fk_positions_lanes(self.model, q,
                                  extra_points=self.grasped_extra_points())

    def fk_map_collision_with_jac(self, q):
        """q (..., d) -> (points (..., P, 3), J (..., P, 3, d)): world link
        positions and the grasped points, with their analytic point
        Jacobians, from one lanes FK pass."""
        from ..ops.lanes_fk import fk_points_jacobians_lanes
        return fk_points_jacobians_lanes(
            self.model, q, extra_points=self.grasped_extra_points())

    def get_EE_pose(self, q):
        """q (..., d) -> the end effector's pose (..., 1, 4, 4)."""
        return fk_all_links(self.model, q, link_list=[self.link_name_ee])

    def get_EE_position(self, q):
        """q (..., d) -> the end effector's position (..., 3)."""
        return self.get_EE_pose(q)[..., 0, :3, 3]

    def get_EE_orientation(self, q, rotation_matrix: bool = True):
        """q (..., d) -> the end effector's rotation (..., 3, 3), or its
        wxyz quaternion (..., 4)."""
        H = self.get_EE_pose(q)
        if rotation_matrix:
            return H[..., 0, :3, :3]
        return link_quat_from_link_tensor(H[..., 0, :, :])


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
        self_coll_pairs=UR10_SELF_COLL_PAIRS, link_name_ee="ee_link",
        name="RobotUR10")
