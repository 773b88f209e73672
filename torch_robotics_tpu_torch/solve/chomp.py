"""Batched CHOMP: covariant gradient descent on trajectories (counterpart
of torch_robotics_tpu/solve/chomp.py).

Each iteration takes the functional gradient of the prior-weighted GP
smoothness energy plus the obstacle cost, clips it, preconditions it by the
smoothness metric (the GP prior's block-tridiagonal Hessian, the one GPMP2
uses) and steps.  The obstacle gradient comes from the task's lanes terms
(``obstacle_terms_lanes``: the terms kernel K1 on the card) where the
residual function has them, else from autograd through the residuals (the
planar 2-link arm; any plain residual function).  The cost trace comes from
the task's value-only cost (``collision_cost_lanes``: K8 on the card)
where it has one, else from the residual values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..core.device import disable_tf32
from .gp_prior import gp_prior_terms
from .gpmp2 import _solve_generic

__all__ = ["CHOMPParams", "CHOMPResult", "chomp_solve"]

@dataclasses.dataclass(frozen=True)
class CHOMPParams:
    n_support_points: int = 64
    dt: float = 0.04
    opt_iters: int = 100
    weight_prior_cost: float = 1e-4
    step_size: float = 0.05
    grad_clip: float = 0.05
    sigma_start: float = 1e-3
    sigma_gp: float = 1e-1
    sigma_goal: float = 1e-3
    sigma_coll: float = 1e-2

    @classmethod
    def from_preset(cls, preset: dict) -> "CHOMPParams":
        """From a reference-style planner-params dict
        (``EnvBase.get_chomp_params``)."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in preset.items() if k in known}
        kwargs = {k: (int(v) if k in ("n_support_points", "opt_iters") else v)
                  for k, v in kwargs.items()}
        return cls(**kwargs)


class CHOMPResult(NamedTuple):
    trajs: torch.Tensor          # (..., H, 2d) optimized trajectories
    cost_trace: torch.Tensor     # (opt_iters,) or (opt_iters, ...)


def _precondition(D, U, g):
    """Solve (D + 1e-6 I, U) x = g for the clipped gradient g (B, H, m),
    with the shared prior blocks D (H, m, m), U (H-1, m, m), as the generic
    GN step solves (``gpmp2._solve_generic``): m <= 32 in the lanes layout
    (the sweep kernel on the card, the plain lanes solve on the CPU),
    larger m batch-major."""
    m = g.shape[-1]
    return _solve_generic(
        D + 1e-6 * torch.eye(m, dtype=g.dtype, device=g.device), U, g)


def chomp_solve(residual_fn: Callable, theta0, start_state, goal_state,
                params: CHOMPParams,
                per_problem_trace: bool = False) -> CHOMPResult:
    """``params.opt_iters`` CHOMP iterations from theta0 (..., H, 2d).

    The obstacle cost is lam sum 0.5 r^2 of the residuals r of
    ``residual_fn`` (lam = 1 / sigma_coll^2).  Its gradient is the lanes
    terms' where ``residual_fn`` carries ``obstacle_terms_lanes`` (a
    PlanningTask's ``collision_residuals`` with a lanes path), else
    autograd's through the residuals: one call on the whole flattened batch
    where ``residual_fn.supports_batch`` is set, ``torch.vmap`` of it
    otherwise.  That branch never calls ``collision_cost_lanes``, whose
    kernel has no backward, and it raises where the residuals carry no
    gradient to theta.  start/goal (..., 2d).  ``cost_trace`` is the
    batch-summed obstacle cost of each iteration's result (iters,), from
    ``collision_cost_lanes`` where the task has it, else from the
    residuals; with ``per_problem_trace`` it keeps the batch axis (iters,
    ...), as the sharded wrapper needs to leave padded rows out.

    The preconditioning solve follows the reference's split at m = 32: the
    lanes layout below it, batch-major above.  On the card the lanes solve
    is the block-tridiagonal sweep kernel (``ops/btridiag_kernel.
    solve_lanes_auto``: K2 for m <= 16, e.g. the Panda's 14, the planar
    arm's 4) on D + 1e-6 I broadcast over the batch with the shared U; on
    the CPU it is the plain lanes solve (``gpmp2._solve_generic``).  The
    reference preconditions with its plain XLA lanes solve here; the two
    compute the same solve.  Runs at full float32 matmul precision (TF32
    off).
    """
    disable_tf32()
    lanes_terms = getattr(residual_fn, "obstacle_terms_lanes", None)
    cost_lanes = getattr(residual_fn, "collision_cost_lanes", None)
    batched = getattr(residual_fn, "supports_batch", False)
    batch, (H, m) = theta0.shape[:-2], theta0.shape[-2:]
    d = m // 2
    lam = 1.0 / (params.sigma_coll ** 2)
    theta = theta0.reshape((-1, H, m))
    start = start_state.reshape((-1, m)) if start_state.dim() > 1 \
        else start_state
    goal = goal_state.reshape((-1, m)) if goal_state.dim() > 1 \
        else goal_state

    def residuals(th):
        """Residuals (B H, P) of the waypoints of th (B, H, m)."""
        q_flat = th[..., :d].reshape(-1, d)
        r = residual_fn(q_flat) if batched else torch.vmap(residual_fn)(q_flat)
        return r.reshape(r.shape[0], -1)

    def cost_per_traj(th):
        """Obstacle cost per trajectory (B,): the value-only cost where the
        task has one, else 0.5 lam sum r^2 of the residuals."""
        if cost_lanes is not None:
            q_cols = th[..., :d].reshape(-1, d).T.contiguous()
            c_pt = lam * cost_lanes(q_cols)
        else:
            c_pt = 0.5 * lam * torch.square(residuals(th)).sum(-1)
        return c_pt.reshape(th.shape[0], H).sum(-1)

    def obstacle_grad(th):
        """d obstacle cost / d theta (B, H, m); the velocity rows are 0."""
        if lanes_terms is not None:
            q_cols = th[..., :d].reshape(-1, d).T.contiguous()    # (d, N)
            g_q = lanes_terms(q_cols, lam)[0]         # (m, N), velocity 0
            return g_q.T.reshape(th.shape)
        with torch.enable_grad():
            th = th.detach().requires_grad_(True)
            r = residuals(th)
            g = (torch.autograd.grad(0.5 * lam * torch.sum(torch.square(r)),
                                     th, allow_unused=True)[0]
                 if r.requires_grad else None)
        if g is None:
            raise RuntimeError(
                "chomp_solve: the residuals of %r carry no gradient to the "
                "trajectory (a kernel with no backward on their path?); "
                "CHOMP needs differentiable residuals or lanes terms"
                % (residual_fn,))
        return g

    trace = []
    for _ in range(params.opt_iters):
        g_gp, D, U = gp_prior_terms(
            theta, start, goal, params.dt, params.sigma_start,
            params.sigma_gp, params.sigma_goal)
        g = params.weight_prior_cost * g_gp + obstacle_grad(theta)
        g = torch.clamp(g, -params.grad_clip, params.grad_clip)
        theta = theta - params.step_size * _precondition(D, U, g)
        cost = cost_per_traj(theta)
        trace.append(cost if per_problem_trace else torch.sum(cost))
    trace = (torch.stack(trace) if trace
             else torch.zeros((0,) + ((theta.shape[0],) if per_problem_trace
                                      else ()), dtype=theta.dtype,
                              device=theta.device))
    if per_problem_trace:
        trace = trace.reshape((params.opt_iters,) + batch)
    return CHOMPResult(trajs=theta.reshape(theta0.shape), cost_trace=trace)
