from . import robot_zoo
from .fk import fk_all_links
from .model import (JOINT_CONTINUOUS, JOINT_FIXED, JOINT_PRISMATIC,
                    JOINT_REVOLUTE, KinematicModel)

__all__ = ["KinematicModel", "fk_all_links", "robot_zoo", "JOINT_FIXED", "JOINT_REVOLUTE",
           "JOINT_CONTINUOUS", "JOINT_PRISMATIC"]
