from .device import resolve_device
from .pytrees import safe_norm
from .random import fix_random_seed
from .se3 import pack_homogeneous, x_rot, y_rot, z_rot
from .timer import TimerCUDA
from .utils import to_numpy, to_torch

__all__ = ["resolve_device", "safe_norm", "x_rot", "y_rot", "z_rot",
           "pack_homogeneous", "TimerCUDA", "fix_random_seed", "to_numpy",
           "to_torch"]
