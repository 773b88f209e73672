"""Trajectory quality metrics (counterpart of
torch_robotics_tpu/trajectory/metrics.py): path length, the variance of
the batch's waypoint spread and smoothness, the MPOT workload's quality
metrics."""
from __future__ import annotations

import torch

__all__ = ["compute_path_length", "compute_variance_waypoints",
           "compute_smoothness"]


def compute_path_length(trajs, robot):
    """Sum of consecutive waypoint distances: (B, H, D) -> (B,)."""
    trajs_pos = robot.get_position(trajs)
    return torch.sum(torch.linalg.vector_norm(
        torch.diff(trajs_pos, dim=-2), dim=-1), dim=-1)


def compute_variance_waypoints(trajs, robot):
    """Sum over the horizon of the (unbiased) variance of the batch's
    pairwise waypoint distances, the strict upper triangle flattened with
    its zeros, as the reference's ``torch.triu(...).view(-1)``: (B, H, D)
    -> ()."""
    pts = torch.swapaxes(robot.get_position(trajs), 0, 1)      # (H, B, D)
    d = torch.linalg.vector_norm(pts[:, :, None, :] - pts[:, None, :, :],
                                 dim=-1)
    triu = torch.triu(d, diagonal=1).reshape(d.shape[0], -1)
    return torch.sum(torch.var(triu, dim=-1, correction=1))


def compute_smoothness(trajs, robot, trajs_vel=None):
    """Sum over the horizon of ||velocity change||: (B, H, D) -> (B,)."""
    if trajs_vel is None:
        trajs_vel = robot.get_velocity(trajs)
    return torch.sum(torch.linalg.vector_norm(
        torch.diff(trajs_vel, dim=-2), dim=-1), dim=-1)
