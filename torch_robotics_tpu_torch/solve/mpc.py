"""Receding-horizon MPC over the GPMP2 Gauss-Newton solver (counterpart of
torch_robotics_tpu/solve/mpc.py).

Each control step re-optimizes the H-step plan from the current state with
a few warm-started GN iterations, advances to the plan's next waypoint and
shifts the plan one step.  Batched over independent problems.  An
optional ``ee_goal_terms`` (``solve.ee_goal``) puts an EE-pose goal factor
on the horizon's final waypoint: Cartesian-goal MPC without IK.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .gp_prior import straight_line_trajs
from .gpmp2 import GPMP2Params, gpmp2_step

__all__ = ["MPCParams", "MPCState", "mpc_init", "mpc_step", "mpc_rollout"]


@dataclasses.dataclass(frozen=True)
class MPCParams:
    gpmp2: GPMP2Params = GPMP2Params()
    iters_per_step: int = 2      # warm-started GN iterations per step


class MPCState(NamedTuple):
    theta: torch.Tensor          # (B, H, 2d) current plan
    x: torch.Tensor              # (B, 2d) current state


def mpc_init(start_state, goal_state, params: MPCParams) -> MPCState:
    """Start every plan as the straight line between the endpoints."""
    theta = straight_line_trajs(start_state, goal_state,
                                params.gpmp2.n_support_points)
    return MPCState(theta=theta, x=start_state)


def mpc_step(residual_fn: Callable, state: MPCState, goal_state,
             params: MPCParams, ee_goal_terms: Callable = None):
    """One receding-horizon control step -> (next MPCState, info dict with
    the last iteration's ``collision_cost`` (B,) and ``dist_to_goal``)."""
    theta = state.theta
    cost = None
    for _ in range(params.iters_per_step):
        theta, cost = gpmp2_step(residual_fn, theta, state.x, goal_state,
                                 params.gpmp2, ee_goal_terms)
    x_next = theta[..., 1, :]
    theta_shifted = torch.cat([theta[..., 1:, :], theta[..., -1:, :]],
                              dim=-2)
    d = x_next.shape[-1] // 2
    return (MPCState(theta=theta_shifted, x=x_next),
            {"collision_cost": cost,
             "dist_to_goal": torch.linalg.vector_norm(
                 x_next[..., :d] - goal_state[..., :d], dim=-1)})


def mpc_rollout(residual_fn: Callable, start_state, goal_state,
                params: MPCParams, n_steps: int,
                ee_goal_terms: Callable = None):
    """Run ``n_steps`` receding-horizon steps from the straight-line plans
    -> (executed states (B, n_steps, 2d), info dict with ``dist_to_goal``
    (n_steps, B) and ``final_state``, the MPCState after the last step)."""
    state = mpc_init(start_state, goal_state, params)
    xs, dists = [], []
    for _ in range(n_steps):
        state, info = mpc_step(residual_fn, state, goal_state, params,
                               ee_goal_terms)
        xs.append(state.x)
        dists.append(info["dist_to_goal"])
    return (torch.stack(xs, dim=-2),
            {"dist_to_goal": torch.stack(dists), "final_state": state})
