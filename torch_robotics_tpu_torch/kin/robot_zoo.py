"""Named kinematic models compiled from the vendored URDFs (counterpart of
torch_robotics_tpu/kin/robot_zoo.py; the Panda, with or without a grasped
object, the UR10 and the planar 2-link arm so far)."""
from __future__ import annotations

import torch

from ..core.quaternion import q_to_euler
from ..utils.files import get_robot_path
from .model import KinematicModel
from .urdf import UrdfJoint, UrdfLink, parse_urdf

__all__ = ["franka_panda", "planar_2_link", "ur10"]


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


def ur10(device="cuda") -> KinematicModel:
    """Universal Robots UR10 arm (6 revolute joints, ``ee_link`` fixed; no
    suction gripper in this slice)."""
    return KinematicModel.from_urdf_robot(
        parse_urdf(get_robot_path() / "ur10/urdf/ur10.urdf"),
        name="differentiable_ur10", device=device)


def planar_2_link(device="cuda") -> KinematicModel:
    """The planar two-link arm's URDF (two revolute joints about z)."""
    return KinematicModel.from_urdf_robot(
        parse_urdf(get_robot_path()
                   / "planar_manipulators/urdf/2_link_planar.urdf"),
        name="differentiable_2_link_planar", device=device)
