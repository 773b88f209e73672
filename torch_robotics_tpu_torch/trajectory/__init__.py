from .utils import interpolate_traj_via_points

__all__ = ["interpolate_traj_via_points"]
