"""Rigid-body helpers (counterpart of the functions of
torch_robotics_tpu/core/se3.py that the ported paths use: the URDF and
Rodrigues rotations, and the coordinate-axis rotations of multi-robot base
poses)."""
from __future__ import annotations

import torch

from .device import resolve_device

__all__ = ["x_rot", "y_rot", "z_rot", "rpy_to_rotation_matrix",
           "axis_angle_rotation", "rotate_point"]


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _rot_from_cs(c, s, axis: int) -> torch.Tensor:
    """Rotation about coordinate axis ``axis`` from cos / sin values."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == 1:
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(c.shape + (3, 3))


def _axis_rot(angle, axis: int, device) -> torch.Tensor:
    if not torch.is_tensor(angle):
        angle = torch.tensor(angle, dtype=torch.float32,
                             device=resolve_device(device))
    return _rot_from_cs(torch.cos(angle), torch.sin(angle), axis)


def x_rot(angle, device="cuda") -> torch.Tensor:
    """Rotation about x by ``angle`` (...,) -> (..., 3, 3), on the angle's
    device (``device`` for a Python number)."""
    return _axis_rot(angle, 0, device)


def y_rot(angle, device="cuda") -> torch.Tensor:
    """Rotation about y by ``angle``, as ``x_rot``."""
    return _axis_rot(angle, 1, device)


def z_rot(angle, device="cuda") -> torch.Tensor:
    """Rotation about z by ``angle``, as ``x_rot``."""
    return _axis_rot(angle, 2, device)


def rpy_to_rotation_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF fixed-frame rotation R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1).reshape(rpy.shape[:-1] + (3, 3))


def axis_angle_rotation(axis: torch.Tensor, angle: torch.Tensor):
    """Rodrigues rotation about a unit axis: axis (..., 3), angle (...,) ->
    (..., 3, 3)."""
    K = _skew(axis)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def rotate_point(point: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """point @ R^T in row-vector form: (..., 3) x (..., 3, 3) -> (..., 3)."""
    return torch.matmul(point[..., None, :], rot.transpose(-1, -2))[..., 0, :]
