from .fields import interpolate_points

__all__ = ["interpolate_points"]
