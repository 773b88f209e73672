from .utils import interpolate_traj_via_points, smoothen_trajectory

__all__ = ["interpolate_traj_via_points", "smoothen_trajectory"]
