"""Rigid-body helpers (counterpart of the functions of
torch_robotics_tpu/core/se3.py that the main path uses)."""
from __future__ import annotations

import torch

__all__ = ["rpy_to_rotation_matrix", "axis_angle_rotation", "rotate_point"]


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


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
