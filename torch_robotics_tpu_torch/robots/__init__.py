from .base import RobotAPI, build_object_margins, build_self_collision_pairs
from .panda import RobotPanda

__all__ = ["RobotAPI", "RobotPanda", "build_object_margins",
           "build_self_collision_pairs"]
