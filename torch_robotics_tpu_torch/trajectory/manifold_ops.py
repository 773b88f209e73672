"""Trajectory operations on product manifolds (counterpart of
torch_robotics_tpu/trajectory/manifold_ops.py): finite-difference
derivatives in the tangent space and tangent-space smoothing, for
trajectories of points of a ``core.manifold.Manifold`` (for example a
position x orientation path, R^3 x S^3).
"""
from __future__ import annotations

import torch

from ..core.manifold import Manifold

__all__ = ["compute_traj_velocity", "compute_traj_derivatives", "smooth_traj"]


def compute_traj_velocity(traj: torch.Tensor, dt: float,
                          manifold: Manifold) -> torch.Tensor:
    """traj (..., H, dim_M) -> velocities (..., H, dim_T): v_t =
    log_{x_t}(x_{t+1}) / dt, the last one repeated."""
    v = manifold.log_map(traj[..., 1:, :], base=traj[..., :-1, :]) / dt
    return torch.cat([v, v[..., -1:, :]], dim=-2)


def compute_traj_derivatives(traj: torch.Tensor, dt: float,
                             manifold: Manifold, smooth: bool = False,
                             window: int = 5):
    """(position, velocity, acceleration) along a manifold trajectory,
    smoothed first with ``smooth``."""
    if smooth:
        traj = smooth_traj(traj, manifold, window=window)
    vel = compute_traj_velocity(traj, dt, manifold)
    acc = (torch.cat([vel[..., 1:, :], vel[..., -1:, :]], dim=-2)
           - vel) / dt
    return traj, vel, acc


def smooth_traj(traj: torch.Tensor, manifold: Manifold,
                window: int = 5) -> torch.Tensor:
    """Moving average in the tangent space of each inner point over a
    window of ``window`` points (clipped at the ends); the end points stay."""
    H = traj.shape[-2]
    half = window // 2
    out = [traj[..., :1, :]]
    for t in range(1, H - 1):
        lo, hi = max(0, t - half), min(H, t + half + 1)
        base = traj[..., t, :]
        vs = [manifold.log_map(traj[..., s, :], base=base)
              for s in range(lo, hi)]
        mean_v = sum(vs) / len(vs)
        out.append(manifold.exp_map(mean_v, base=base)[..., None, :])
    out.append(traj[..., -1:, :])
    return torch.cat(out, dim=-2)
