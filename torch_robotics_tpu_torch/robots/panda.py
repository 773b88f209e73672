"""Franka Panda embodiment: URDF kinematics + sphere collision model
(counterpart of torch_robotics_tpu/robots/panda.py).

Object-collision links {panda_link2,3,5,7,hand} with margins
{.125,.125,.13,.1,.08}, and the reference's self-collision pair table.
The grasped object and the learned self-collision net wait for a later
slice.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..kin import robot_zoo
from .base import build_object_margins, build_self_collision_pairs
from .kinematic_robot import KinematicRobot

__all__ = ["RobotPanda", "PANDA_OBJECT_COLL_LINKS",
           "PANDA_OBJECT_COLL_MARGINS", "PANDA_SELF_COLL_PAIRS"]

PANDA_OBJECT_COLL_LINKS = [
    "panda_link2", "panda_link3", "panda_link5", "panda_link7", "panda_hand",
]
PANDA_OBJECT_COLL_MARGINS = [0.125, 0.125, 0.13, 0.1, 0.08]

PANDA_SELF_COLL_PAIRS = OrderedDict({
    "panda_link4": ["panda_link1"],
    "panda_link5": ["panda_link0", "panda_link1", "panda_link2"],
    "panda_link6": ["panda_link0", "panda_link1", "panda_link2"],
    "panda_hand": ["panda_link0", "panda_link1", "panda_link2"],
})
PANDA_SELF_COLL_LINKS_GRASPED = [
    "panda_link0", "panda_link1", "panda_link2", "panda_link3",
]


@dataclasses.dataclass(frozen=True)
class RobotPanda(KinematicRobot):
    """The Panda as a ``KinematicRobot``.  ``create`` builds it from its
    URDF; ``convert.task_from_numpy`` builds one from exported arrays."""
    name: str = "RobotPanda"

    @classmethod
    def create(cls, self_collision_margin_robot: float = 0.05,
               device="cuda") -> "RobotPanda":
        model = robot_zoo.franka_panda(device=device)
        dev = model.device
        name_to_idx = {n: i for i, n in enumerate(model.link_names)}
        object_coll_idxs = tuple(name_to_idx[n]
                                 for n in PANDA_OBJECT_COLL_LINKS)
        object_margins, _, _ = build_object_margins(
            PANDA_OBJECT_COLL_MARGINS, len(PANDA_OBJECT_COLL_LINKS))

        self_names = []
        for k, v in PANDA_SELF_COLL_PAIRS.items():
            self_names.append(k)
            self_names.extend(v)
        self_names.extend(PANDA_SELF_COLL_LINKS_GRASPED)
        self_names = sorted(set(self_names))
        self_coll_idxs = tuple(name_to_idx[n] for n in self_names)
        pair_idxs, self_margins = build_self_collision_pairs(
            self_names, PANDA_SELF_COLL_PAIRS, points_per_link=1,
            margin_robot=self_collision_margin_robot)

        return cls(
            model=model,
            q_min=torch.as_tensor(model.q_lower, device=dev),
            q_max=torch.as_tensor(model.q_upper, device=dev),
            object_margins=torch.as_tensor(object_margins, device=dev),
            self_margins=torch.as_tensor(self_margins, device=dev),
            object_coll_idxs=object_coll_idxs,
            self_coll_idxs=self_coll_idxs,
            self_pair_idxs=tuple(map(tuple, pair_idxs.tolist())),
        )
