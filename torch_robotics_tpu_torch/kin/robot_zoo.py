"""Named kinematic models compiled from the vendored URDFs (counterpart of
torch_robotics_tpu/kin/robot_zoo.py; the Panda and the UR10 so far)."""
from __future__ import annotations

from ..utils.files import get_robot_path
from .model import KinematicModel
from .urdf import parse_urdf

__all__ = ["franka_panda", "ur10"]


def franka_panda(gripper: bool = False, device="cuda") -> KinematicModel:
    """Franka Panda arm (no grasped object in this slice)."""
    rel = ("franka_description/robots/panda_arm_hand.urdf" if gripper
           else "franka_description/robots/panda_arm_no_gripper.urdf")
    robot = parse_urdf(get_robot_path() / rel)
    return KinematicModel.from_urdf_robot(
        robot, name="differentiable_franka_panda", device=device)


def ur10(device="cuda") -> KinematicModel:
    """Universal Robots UR10 arm (6 revolute joints, ``ee_link`` fixed; no
    suction gripper in this slice)."""
    return KinematicModel.from_urdf_robot(
        parse_urdf(get_robot_path() / "ur10/urdf/ur10.urdf"),
        name="differentiable_ur10", device=device)
