from .metrics import (compute_path_length, compute_smoothness,
                      compute_variance_waypoints)
from .utils import interpolate_traj_via_points, smoothen_trajectory

__all__ = ["compute_path_length", "compute_smoothness",
           "compute_variance_waypoints", "interpolate_traj_via_points",
           "smoothen_trajectory"]
