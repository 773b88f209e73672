from . import robot_zoo
from .fk import (analytical_jacobian, fk_all_links, fk_link_positions,
                 fk_rot_trans, fk_with_velocities, geometric_jacobian,
                 local_joint_transforms, point_jacobians)
from .ik import (IKResult, ik_loss_per_q, ik_valid_mask, inverse_kinematics,
                 inverse_kinematics_gn)
from .model import (JOINT_CONTINUOUS, JOINT_FIXED, JOINT_PRISMATIC,
                    JOINT_REVOLUTE, KinematicModel)
from .skeleton import (Skeleton, get_skeleton_from_landmarks,
                       get_skeleton_from_model)

__all__ = ["KinematicModel", "fk_all_links", "fk_rot_trans",
           "fk_link_positions", "fk_with_velocities", "geometric_jacobian",
           "point_jacobians", "analytical_jacobian", "local_joint_transforms",
           "IKResult", "ik_loss_per_q", "ik_valid_mask", "inverse_kinematics",
           "inverse_kinematics_gn", "robot_zoo", "Skeleton",
           "get_skeleton_from_model", "get_skeleton_from_landmarks",
           "JOINT_FIXED", "JOINT_REVOLUTE", "JOINT_CONTINUOUS",
           "JOINT_PRISMATIC"]
