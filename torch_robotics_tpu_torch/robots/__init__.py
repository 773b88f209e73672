from .base import RobotAPI, build_object_margins, build_self_collision_pairs
from .kinematic_robot import KinematicRobot, RobotUR10
from .multi_robot import MultiRobot
from .panda import RobotPanda
from .planar2link import RobotPlanar2Link
from .point_mass import RobotPointMass, RobotPointMass3D

__all__ = ["RobotAPI", "RobotPanda", "KinematicRobot", "RobotUR10",
           "MultiRobot", "RobotPlanar2Link", "RobotPointMass",
           "RobotPointMass3D",
           "build_object_margins", "build_self_collision_pairs"]
