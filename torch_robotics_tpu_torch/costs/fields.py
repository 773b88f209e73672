"""Collision-point helpers and occupancy checks (counterpart of the part
of torch_robotics_tpu/costs/fields.py that the robots, the planning task's
collision checks and the quality metrics need).

Every check takes collision points ``(..., P, dim)`` with any leading batch
dims and returns per-configuration flags ``(...)``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.pytrees import safe_norm

__all__ = ["interpolate_points", "object_signed_distances",
           "object_collision_any", "self_collision_distances",
           "self_collision_any", "workspace_bounds_distances",
           "workspace_bounds_any"]


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


def object_signed_distances(df_obj_list: Sequence, points):
    """SDF of each distance-field object: points (..., P, dim) ->
    (..., n_objs, P)."""
    return torch.stack([df.signed_distance(points) for df in df_obj_list],
                       dim=-2)


def object_collision_any(df_obj_list, points, margins, cutoff_margin=0.0):
    """Any point closer to any object than its margin (+ cutoff)."""
    sd = object_signed_distances(df_obj_list, points)
    return (sd < (margins + cutoff_margin)).flatten(-2).any(-1)


def self_collision_distances(points, pair_idxs):
    """Distances between configured point pairs: points (..., P, d),
    pair_idxs (n_pairs, 2) -> (..., n_pairs)."""
    pair_idxs = np.asarray(pair_idxs).reshape(-1, 2)
    a = points[..., pair_idxs[:, 0], :]
    b = points[..., pair_idxs[:, 1], :]
    return safe_norm(a - b, dim=-1)


def self_collision_any(points, pair_idxs, margins):
    return torch.any(self_collision_distances(points, pair_idxs) < margins,
                     dim=-1)


def workspace_bounds_distances(points, ws_min, ws_max):
    """Signed distances of points to each workspace face:
    points (..., P, dim) -> (..., 2 dim, P) (faces act as objects)."""
    d = torch.cat([points - ws_min, ws_max - points], dim=-1)
    return torch.swapaxes(d, -1, -2)


def workspace_bounds_any(points, ws_min, ws_max, margins, cutoff_margin=0.0):
    sd = workspace_bounds_distances(points, ws_min, ws_max)
    return (sd < (margins + cutoff_margin)).flatten(-2).any(-1)
