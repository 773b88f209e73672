"""Collision-point helpers (counterpart of the part of
torch_robotics_tpu/costs/fields.py that the robot base needs)."""
from __future__ import annotations

import torch

__all__ = ["interpolate_points"]


def interpolate_points(points: torch.Tensor, num_interpolated_points: int):
    """Linearly resample P points to N points along the point axis
    (align_corners=True semantics): points (..., P, d) -> (..., N, d)."""
    P = points.shape[-2]
    N = num_interpolated_points
    if N == P:
        return points
    if P == 1:
        return torch.repeat_interleave(points, N, dim=-2)
    pos = torch.linspace(0.0, P - 1.0, N, dtype=points.dtype,
                         device=points.device)
    i0 = torch.clamp(torch.floor(pos).long(), 0, P - 2)
    frac = (pos - i0.to(points.dtype))[..., None]
    return points[..., i0, :] * (1.0 - frac) + points[..., i0 + 1, :] * frac
