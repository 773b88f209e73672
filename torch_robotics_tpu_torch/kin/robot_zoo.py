"""Named kinematic models compiled from the vendored URDFs (counterpart of
torch_robotics_tpu/kin/robot_zoo.py, the same names, URDF files and model
names).  The URDFs are read in place from the JAX package's data
directory (``utils/files.get_robot_path``)."""
from __future__ import annotations

import torch

from ..core.quaternion import q_to_euler
from ..utils.files import get_robot_path
from .model import KinematicModel
from .urdf import UrdfJoint, UrdfLink, parse_urdf

__all__ = [
    "kuka_iiwa7", "franka_panda", "ur10", "habitat_stretch",
    "tiago_dual_holo", "tiago_dual_holo_move", "shadow_hand", "allegro_hand",
    "planar_2_link",
]


def _load(rel_path: str, name: str, device) -> KinematicModel:
    return KinematicModel.from_urdf(get_robot_path() / rel_path, name=name,
                                    device=device)


def kuka_iiwa7(device="cuda") -> KinematicModel:
    """KUKA LBR iiwa 7 (7 revolute joints, a chain)."""
    return _load("kuka_iiwa/urdf/iiwa7.urdf", "differentiable_kuka_iiwa",
                 device)


def franka_panda(gripper: bool = False, grasped_object=None,
                 device="cuda") -> KinematicModel:
    """Franka Panda arm; with ``grasped_object`` (``pos`` (3,) and ``ori``
    wxyz (4,) in the ``panda_hand`` frame) a fixed link ``grasped_object``
    is appended, its joint's rpy the float32 ``q_to_euler`` of ``ori``."""
    rel = ("franka_description/robots/panda_arm_hand.urdf" if gripper
           else "franka_description/robots/panda_arm_no_gripper.urdf")
    robot = parse_urdf(get_robot_path() / rel)
    if grasped_object is not None:
        pos = grasped_object.pos.detach().cpu().to(torch.float32)
        ori = grasped_object.ori.detach().cpu().to(torch.float32)
        rpy = q_to_euler(ori)
        robot.joints.append(UrdfJoint(
            name="grasped_object_fixed_joint", type="fixed",
            parent="panda_hand", child="grasped_object",
            origin_xyz=tuple(float(v) for v in pos.reshape(3)),
            origin_rpy=tuple(float(v) for v in rpy.reshape(3)),
            axis=(0.0, 0.0, 0.0)))
        robot.links.append(UrdfLink(name="grasped_object"))
    return KinematicModel.from_urdf_robot(
        robot, name="differentiable_franka_panda", device=device)


def ur10(attach_gripper: bool = False, device="cuda") -> KinematicModel:
    """Universal Robots UR10 arm (6 revolute joints, ``ee_link`` fixed),
    with its suction gripper's fixed link ``ee_suction_link`` when
    ``attach_gripper``."""
    rel = ("ur10/urdf/ur10_suction.urdf" if attach_gripper
           else "ur10/urdf/ur10.urdf")
    return _load(rel, "differentiable_ur10", device)


def habitat_stretch(device="cuda") -> KinematicModel:
    """Hello Robot Stretch as Habitat ships it (14 joints: continuous
    wheels, a prismatic lift and telescoping arm, revolute wrist, head and
    fingers)."""
    return _load("habitat_stretch/urdf/hab_stretch.urdf",
                 "differentiable_stretch", device)


def tiago_dual_holo(device="cuda") -> KinematicModel:
    """PAL TIAGo dual-arm on its holonomic base, base fixed: two 7-DoF arms
    off ``torso_lift_link`` (14 joints, 19 links)."""
    return _load("tiago_dual_description/tiago_dual_holobase_minimal.urdf",
                 "differentiable_tiago_dual_holo", device)


def tiago_dual_holo_move(device="cuda") -> KinematicModel:
    """The dual-arm TIAGo with its base's x, y (prismatic) and yaw
    (continuous) and the torso lift as joints (18 joints, 22 links)."""
    return _load(
        "tiago_dual_description/tiago_dual_holobase_minimal_holonomic.urdf",
        "differentiable_tiago_dual_holo_move", device)


def shadow_hand(device="cuda") -> KinematicModel:
    """Shadow Dexterous Hand (24 joints, five finger chains off the palm;
    LFJ5 turns about its true, non-axis-aligned axis)."""
    return _load("shadow_hand/shadow_hand.urdf", "differentiable_shadow_hand",
                 device)


def allegro_hand(device="cuda") -> KinematicModel:
    """Wonik Allegro hand (16 joints, four finger chains off the palm)."""
    return _load("allegro_hand/allegro_hand.urdf",
                 "differentiable_allegro_hand", device)


def planar_2_link(device="cuda") -> KinematicModel:
    """The planar two-link arm's URDF (two revolute joints about z)."""
    return _load("planar_manipulators/urdf/2_link_planar.urdf",
                 "differentiable_2_link_planar", device)
