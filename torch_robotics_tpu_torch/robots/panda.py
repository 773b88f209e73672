"""Franka Panda embodiment: URDF kinematics + sphere collision model
(counterpart of torch_robotics_tpu/robots/panda.py).

Object-collision links {panda_link2,3,5,7,hand} with margins
{.125,.125,.13,.1,.08}, and the reference's self-collision pair table.
``use_learned_self_collision`` swaps the pair rows for the learned
self-collision net (the reference's STORM override).  A grasped object
(``geom.GraspedObjectPandaBox``) adds a fixed link to the hand; its base
points follow the links as object points (margin 0.001) and as self points
paired with panda_link0-3 (margin 0.05).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..costs.self_collision_net import SelfCollisionNet
from ..kin import robot_zoo
from ..utils.files import get_data_path
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
    def create(cls, grasped_object=None,
               margin_for_grasped_object_collision_checking: float = 0.001,
               self_collision_margin_robot: float = 0.05,
               self_collision_margin_grasped_object: float = 0.05,
               use_learned_self_collision: bool = False,
               self_collision_net_path=None,
               device="cuda") -> "RobotPanda":
        """``use_learned_self_collision`` loads the learned self-collision
        net (the bundled ``panda_self_collision_net.npz``, read in place,
        or ``self_collision_net_path``); its row replaces the pair rows,
        whose table is still built, as in the reference.  The net was not
        trained with a grasped object, so the two together raise
        ValueError."""
        if use_learned_self_collision and grasped_object is not None:
            raise ValueError(
                "the learned self-collision net does not cover grasped "
                "objects (train a net for the grasping robot instead)")
        model = robot_zoo.franka_panda(grasped_object=grasped_object,
                                       device=device)
        dev = model.device
        grasped_points = (None if grasped_object is None else
                          grasped_object.base_points_for_collision.to(
                              dev, torch.float32))
        grasped_n = 0 if grasped_points is None else grasped_points.shape[0]
        net = None
        if use_learned_self_collision:
            if self_collision_net_path is None:
                self_collision_net_path = (get_data_path()
                                           / "panda_self_collision_net.npz")
            net = SelfCollisionNet.from_npz(self_collision_net_path,
                                            device=dev)
        name_to_idx = {n: i for i, n in enumerate(model.link_names)}
        object_coll_idxs = tuple(name_to_idx[n]
                                 for n in PANDA_OBJECT_COLL_LINKS)
        object_margins, _, _ = build_object_margins(
            PANDA_OBJECT_COLL_MARGINS, len(PANDA_OBJECT_COLL_LINKS),
            grasped_n_points=grasped_n,
            grasped_margin=margin_for_grasped_object_collision_checking)

        self_names = []
        for k, v in PANDA_SELF_COLL_PAIRS.items():
            self_names.append(k)
            self_names.extend(v)
        self_names.extend(PANDA_SELF_COLL_LINKS_GRASPED)
        self_names = sorted(set(self_names))
        self_coll_idxs = tuple(name_to_idx[n] for n in self_names)
        pair_idxs, self_margins = build_self_collision_pairs(
            self_names, PANDA_SELF_COLL_PAIRS, points_per_link=1,
            margin_robot=self_collision_margin_robot,
            grasped_n_points=grasped_n,
            grasped_links=PANDA_SELF_COLL_LINKS_GRASPED,
            grasped_margin=self_collision_margin_grasped_object)

        return cls(
            model=model,
            q_min=torch.as_tensor(model.q_lower, device=dev),
            q_max=torch.as_tensor(model.q_upper, device=dev),
            object_margins=torch.as_tensor(object_margins, device=dev),
            self_margins=torch.as_tensor(self_margins, device=dev),
            object_coll_idxs=object_coll_idxs,
            self_coll_idxs=self_coll_idxs,
            self_pair_idxs=tuple(map(tuple, pair_idxs.tolist())),
            self_collision_net=net,
            grasped_points=grasped_points,
        )
