"""Collision-point helpers, occupancy checks, the 'sdf' costs, the 'rbf'
surrogates and the SE(3) end-effector cost (counterpart of
torch_robotics_tpu/costs/fields.py).

Every check and cost takes collision points ``(..., P, dim)`` with any
leading batch dims and returns per-configuration flags or costs ``(...)``.
An 'sdf' cost row is margin (+ cutoff) - distance, relu-clamped with
``clamp``; the object and workspace costs take the max over objects
(faces) and sum over points, the self-collision cost sums over pairs.
Reductions are ``torch.amax`` and ``torch.relu``, whose gradients at a tie
and at 0 are JAX's (split evenly; 0).  An 'rbf' cost is a Gaussian of the
distance, exp(-d^2 / (2 margin^2)), summed over objects and points (the
object field) or over every ordered pair of points, the diagonal included
(the self field): the reference's formulas, a smooth occupancy surrogate.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.pytrees import safe_norm
from ..core.se3 import SE3_distance

__all__ = ["interpolate_points", "interpolate_points_v2",
           "object_signed_distances", "object_collision_cost",
           "object_collision_any", "object_collision_rbf",
           "self_collision_distances", "self_collision_cost",
           "self_collision_any", "self_collision_rbf",
           "workspace_bounds_distances", "workspace_bounds_cost",
           "workspace_bounds_any", "ee_se3_cost"]


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


def interpolate_points_v2(points, num_interpolate: int,
                          link_interpolate_range):
    """Append ``num_interpolate`` evenly spaced interior points on each
    segment between consecutive points of ``link_interpolate_range`` =
    [lo, hi] (inclusive), after the originals: points (..., P, d) ->
    (..., P + (hi - lo) num_interpolate, d)."""
    if num_interpolate <= 0:
        return points
    lo, hi = link_interpolate_range
    alpha = torch.linspace(0.0, 1.0, num_interpolate + 2, dtype=points.dtype,
                           device=points.device)[1:num_interpolate + 1]
    X = points[..., lo:hi + 1, :]                          # (..., L, d)
    X_diff = X[..., 1:, :] - X[..., :-1, :]
    X_interp = (X[..., :-1, None, :]
                + X_diff[..., None, :] * alpha[:, None])   # (..., L-1, n, d)
    flat = X_interp.reshape(X_interp.shape[:-3]
                            + (X_interp.shape[-3] * num_interpolate,
                               points.shape[-1]))
    return torch.cat([points, flat], dim=-2)


def _hinge_cost(sd, margins, clamp):
    cost = -(sd - margins)
    return torch.relu(cost) if clamp else cost


def object_signed_distances(df_obj_list: Sequence, points):
    """SDF of each distance-field object: points (..., P, dim) ->
    (..., n_objs, P)."""
    return torch.stack([df.signed_distance(points) for df in df_obj_list],
                       dim=-2)


def object_collision_cost(df_obj_list, points, margins, cutoff_margin=0.0,
                          clamp=False):
    """'sdf' obstacle cost: points (..., P, dim), margins (P,) or a scalar
    -> (...), the max over objects summed over points."""
    sd = object_signed_distances(df_obj_list, points)
    cost = _hinge_cost(sd, margins + cutoff_margin, clamp)
    return torch.sum(torch.amax(cost, dim=-2), dim=-1)


def object_collision_any(df_obj_list, points, margins, cutoff_margin=0.0):
    """Any point closer to any object than its margin (+ cutoff)."""
    sd = object_signed_distances(df_obj_list, points)
    return (sd < (margins + cutoff_margin)).flatten(-2).any(-1)


def object_collision_rbf(df_obj_list, points, margin):
    """'rbf' object cost: exp(-sdf^2 / (2 margin^2)) summed over objects
    and points; points (..., P, dim), margin a scalar -> (...)."""
    sd = object_signed_distances(df_obj_list, points)
    return torch.exp(torch.square(sd) / (-2.0 * margin ** 2)).sum(
        dim=(-1, -2))


def self_collision_distances(points, pair_idxs):
    """Distances between configured point pairs: points (..., P, d),
    pair_idxs (n_pairs, 2) -> (..., n_pairs)."""
    pair_idxs = np.asarray(pair_idxs).reshape(-1, 2)
    a = points[..., pair_idxs[:, 0], :]
    b = points[..., pair_idxs[:, 1], :]
    return safe_norm(a - b, dim=-1)


def self_collision_cost(points, pair_idxs, margins, clamp=False):
    """'sdf' self-collision cost: the sum over pairs of margin - distance."""
    d = self_collision_distances(points, pair_idxs)
    return torch.sum(_hinge_cost(d, margins, clamp), dim=-1)


def self_collision_any(points, pair_idxs, margins):
    return torch.any(self_collision_distances(points, pair_idxs) < margins,
                     dim=-1)


def self_collision_rbf(points, margin):
    """'rbf' self-collision cost: exp(-|p_i - p_j|^2 / (2 margin^2)) summed
    over every ordered pair (i, j), the diagonal's ones included; points
    (..., P, d), margin a scalar -> (...)."""
    diff = points[..., :, None, :] - points[..., None, :, :]
    d2 = torch.sum(torch.square(diff), dim=-1)
    return torch.exp(d2 / (-2.0 * margin ** 2)).sum(dim=(-1, -2))


def workspace_bounds_distances(points, ws_min, ws_max):
    """Signed distances of points to each workspace face:
    points (..., P, dim) -> (..., 2 dim, P) (faces act as objects)."""
    d = torch.cat([points - ws_min, ws_max - points], dim=-1)
    return torch.swapaxes(d, -1, -2)


def workspace_bounds_cost(points, ws_min, ws_max, margins, cutoff_margin=0.0,
                          clamp=False):
    """'sdf' workspace cost: each face an object, the max over faces summed
    over points."""
    sd = workspace_bounds_distances(points, ws_min, ws_max)
    cost = _hinge_cost(sd, margins + cutoff_margin, clamp)
    return torch.sum(torch.amax(cost, dim=-2), dim=-1)


def workspace_bounds_any(points, ws_min, ws_max, margins, cutoff_margin=0.0):
    sd = workspace_bounds_distances(points, ws_min, ws_max)
    return (sd < (margins + cutoff_margin)).flatten(-2).any(-1)


def ee_se3_cost(link_tensor, target_H, w_pos=1.0, w_rot=1.0, square=True):
    """SE(3) distance of the last link to a target pose, squared with
    ``square``: link_tensor (..., L, 4, 4), target_H (4, 4) -> (...)."""
    dist = SE3_distance(link_tensor[..., -1, :, :], target_H,
                        w_pos=w_pos, w_rot=w_rot)
    return torch.square(dist) if square else dist
