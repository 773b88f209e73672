"""Trajectory interpolation (counterpart of
torch_robotics_tpu/trajectory/utils.py; only the waypoint interpolation
that the collision metrics use is ported so far)."""
from __future__ import annotations

import torch

__all__ = ["interpolate_traj_via_points"]


def interpolate_traj_via_points(trajs: torch.Tensor,
                                num_interpolation: int = 10):
    """Linear interpolation between consecutive waypoints: for each of the
    H-1 segments, ``num_interpolation`` points at alpha in
    linspace(0, 1, n + 2)[1:n + 1] mixing waypoint_t * alpha +
    waypoint_{t+1} * (1 - alpha).  trajs (..., H, D) ->
    (..., (H - 1) n, D)."""
    H, D = trajs.shape[-2:]
    if num_interpolation <= 0:
        return trajs
    alpha = torch.linspace(0.0, 1.0, num_interpolation + 2,
                           dtype=trajs.dtype, device=trajs.device)
    alpha = alpha[1:num_interpolation + 1].reshape(
        (1,) * (trajs.dim() - 1) + (-1, 1))
    left = trajs[..., :H - 1, None, :]
    right = trajs[..., 1:H, None, :]
    out = left * alpha + right * (1.0 - alpha)
    return out.reshape(trajs.shape[:-2] + ((H - 1) * num_interpolation, D))
