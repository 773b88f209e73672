"""Batched GPMP2 Gauss-Newton steps (counterpart of
torch_robotics_tpu/solve/gpmp2.py, the lanes path that the MPC paths take).

One step assembles the block-tridiagonal normal equations of the GP prior
plus the hinge obstacle terms, in the solver's lanes layout, and solves
them with a block-tridiagonal sweep: the W-persisting sweep for state
blocks m <= 16 (the single Panda, m = 14), the column sweep above that
(the three-arm MultiRobot, m = 40), as the reference routes them
(``ops/btridiag_kernel.solve_lanes_auto``).  On the CPU the plain sweep
takes every m, where the reference takes its tiled solver at m > 32; the
two compute the same solve.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .gp_prior import gp_prior_terms

__all__ = ["GPMP2Params", "gpmp2_step"]


@dataclasses.dataclass(frozen=True)
class GPMP2Params:
    """Solver hyperparameters; field names follow the reference presets."""
    n_support_points: int = 64
    dt: float = 0.04
    opt_iters: int = 100
    sigma_start: float = 1e-5
    sigma_gp: float = 1e-2
    sigma_goal_prior: float = 1e-5
    sigma_coll: float = 1e-5
    step_size: float = 1e-1
    solver_delta: float = 1e-2   # Levenberg damping on the GN system


def _lanes_gn_system(lanes_terms, theta, start_state, goal_state,
                     params: GPMP2Params):
    """GN system for theta (B, H, m) in the solver layout:
    (b_l (H, m, B), D_l (H, m, m, B), U_l (H, m, m, 1), cost_traj (B,)).
    Waypoint lanes are h-major (n = h * B + b)."""
    B, H, m = theta.shape
    d = m // 2
    lam = 1.0 / (params.sigma_coll ** 2)

    q_cols = theta[..., :d].permute(2, 1, 0).reshape(d, H * B)
    g_obs_l, H_obs_l, cost = lanes_terms(q_cols, lam, h=H)

    g_gp, D, U = gp_prior_terms(
        theta, start_state, goal_state, params.dt, params.sigma_start,
        params.sigma_gp, params.sigma_goal_prior)

    b_l = (-(g_gp.permute(1, 2, 0) + g_obs_l)).contiguous()     # (H, m, B)
    eye = torch.eye(m, dtype=theta.dtype, device=theta.device)
    D_l = (D[..., None] + H_obs_l
           + params.solver_delta * eye[..., None]).contiguous()  # (H,m,m,B)
    U_l = torch.cat([U, torch.zeros_like(U[:1])])[..., None].contiguous()
    return b_l, D_l, U_l, torch.sum(cost, dim=0)


def gpmp2_step(residual_fn: Callable, theta, start_state, goal_state,
               params: GPMP2Params):
    """One Gauss-Newton step over a batch of trajectories theta (B, H, m).

    ``residual_fn`` carries ``obstacle_terms_lanes`` (a PlanningTask's
    ``collision_residuals``).  Returns (theta_next, collision cost per
    trajectory (B,))."""
    from ..ops.btridiag_kernel import solve_lanes_auto
    lanes_terms = getattr(residual_fn, "obstacle_terms_lanes", None)
    if lanes_terms is None or theta.dim() != 3:
        raise NotImplementedError(
            "only the lanes GN path (theta (B, H, m) with lanes terms) is "
            "ported")
    b_l, D_l, U_l, cost_traj = _lanes_gn_system(
        lanes_terms, theta, start_state, goal_state, params)
    x_l = solve_lanes_auto(D_l, U_l, b_l)                        # (H, m, B)
    theta_next = theta + params.step_size * x_l.permute(2, 0, 1)
    return theta_next, cost_traj
