from .fields import (ee_se3_cost, interpolate_points, object_collision_any,
                     object_collision_rbf, object_signed_distances,
                     self_collision_any, self_collision_distances,
                     self_collision_rbf, workspace_bounds_any,
                     workspace_bounds_distances)
from .self_collision_net import (SelfCollisionNet, fit_self_collision_net,
                                 self_collision_labels)

__all__ = ["interpolate_points", "object_signed_distances",
           "object_collision_any", "object_collision_rbf",
           "self_collision_distances", "self_collision_any",
           "self_collision_rbf", "workspace_bounds_distances",
           "workspace_bounds_any", "SelfCollisionNet",
           "fit_self_collision_net", "self_collision_labels", "ee_se3_cost"]
