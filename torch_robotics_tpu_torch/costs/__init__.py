from .fields import (interpolate_points, object_collision_any,
                     object_signed_distances, self_collision_any,
                     self_collision_distances, workspace_bounds_any,
                     workspace_bounds_distances)

__all__ = ["interpolate_points", "object_signed_distances",
           "object_collision_any", "self_collision_distances",
           "self_collision_any", "workspace_bounds_distances",
           "workspace_bounds_any"]
