from .device import resolve_device
from .pytrees import safe_norm

__all__ = ["resolve_device", "safe_norm"]
