from .device import resolve_device
from .pytrees import safe_norm
from .se3 import x_rot, y_rot, z_rot

__all__ = ["resolve_device", "safe_norm", "x_rot", "y_rot", "z_rot"]
