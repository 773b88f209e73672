"""Batched GPMP2: Gauss-Newton trajectory optimization on a GP factor
graph (counterpart of torch_robotics_tpu/solve/gpmp2.py).

One step assembles the block-tridiagonal normal equations of the GP prior
plus the hinge obstacle terms and solves them with a block-tridiagonal
sweep.  Two steps, routed as the reference routes them:

- the lanes step, for theta (B, H, m) and a residual function that
  carries ``obstacle_terms_lanes``: the terms come in the solver's lanes
  layout and go to the W-persisting sweep for state blocks m <= 16 (the
  point mass, m = 4; the single Panda, m = 14), the column sweep above that
  (the three-arm MultiRobot, m = 40)
  (``ops/btridiag_kernel.solve_lanes_auto``).  On the CPU the plain sweep
  takes every m, where the reference takes its tiled solver at m > 32; the
  two compute the same solve;
- the generic step, for any other theta (..., H, m) (one trajectory
  (H, m), or several batch dims) or a residual function without lanes
  terms (the planar 2-link arm): the terms come from the residuals and
  their Jacobians (``residuals_and_jacobian`` where the function carries
  it, else ``torch.func.vmap(torch.func.jacfwd(...))``), batch-major; the
  batch is flattened into lanes and, for m <= 32, solved by
  ``solve_lanes_auto`` (on the card K2 for m <= 16, the column sweep
  above; the plain lanes solve on the CPU), for m > 32 by the batch-major
  ``solve/btridiag.block_tridiag_solve``.

The batch solvers run a fixed number of steps (``gpmp2_solve``), resample
and re-solve the trajectories that end in collision
(``gpmp2_solve_restarts``), or stop early on the presets'
``stop_criteria`` (``gpmp2_solve_adaptive``, a host loop that reads the
stop test after every step).

GN factorization reuse (``refactor_every`` = k > 1): iterations 0, k, 2k,
... factor the fresh system with the factor-persisting sweep, the others
re-solve the stale factors against the fresh gradient with the
substitution-only sweep (a substitution iteration still assembles the
whole system and uses its b).  It is taken when the residual function
carries lanes terms and m <= 16, on every device: the kernels on a CUDA
tensor, their plain versions on a CPU tensor.  The reference takes it only
on the TPU and ignores the option elsewhere; here the card is the TPU's
counterpart, and the CPU runs the same schedule so that the tests can hold
it to the reference's interpret-mode run.  For m > 16 the option is
ignored, with a warning, as the reference ignores it.

Every solver takes an optional ``ee_goal_terms`` (``solve.ee_goal.
make_ee_goal_terms``): an EE-pose goal factor added to the final
waypoint's block of each GN system.  Under reuse a substitution iteration
re-solves against the factor of its refactor iteration, whose last block
held that iteration's EE Hessian, as in the reference.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from .gp_prior import gp_prior_terms, sample_gp_prior_trajs

__all__ = ["GPMP2Params", "GPMP2Result", "gpmp2_init_trajs", "gpmp2_solve",
           "gpmp2_solve_adaptive", "gpmp2_solve_restarts", "gpmp2_step"]

# largest state block the reuse schedule takes (the factor-persisting
# sweep's instantiations; the reference's _SCALAR_KERNEL_MAX_M)
_REUSE_MAX_M = 16
# largest state block the generic step solves in the lanes layout (the
# reference's _LANES_SOLVE_MAX_M); larger blocks go batch-major
_LANES_SOLVE_MAX_M = 32


@dataclasses.dataclass(frozen=True)
class GPMP2Params:
    """Solver hyperparameters; field names follow the reference presets."""
    n_support_points: int = 64
    dt: float = 0.04
    opt_iters: int = 100
    num_samples: int = 64
    sigma_start: float = 1e-5
    sigma_gp: float = 1e-2
    sigma_goal_prior: float = 1e-5
    sigma_coll: float = 1e-5
    step_size: float = 1e-1
    sigma_gp_init: float = 0.2
    solver_delta: float = 1e-2   # Levenberg damping on the GN system
    stop_criteria: float = 0.0   # gpmp2_solve_adaptive's stop test
    # GN factorization reuse: refactor every k-th iteration (module doc).
    # Quality-neutral only at weak collision weights (sigma_coll ~5e-3);
    # at production weights stale factors lack the curvature of hinge rows
    # that newly turn active and the steps blow up, as the reference
    # documents (its gpmp2.py, GPMP2Params.refactor_every).
    refactor_every: int = 1

    @classmethod
    def from_preset(cls, preset: dict) -> "GPMP2Params":
        """Build from a reference-style planner-params dict
        (``EnvBase.get_gpmp2_params``)."""
        solver = preset.get("solver_params", {}) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in preset.items() if k in known}
        if "delta" in solver:
            kwargs["solver_delta"] = solver["delta"]
        if preset.get("stop_criteria") is not None:
            kwargs["stop_criteria"] = preset["stop_criteria"]
        kwargs = {k: (int(v) if k in ("n_support_points", "opt_iters",
                                      "num_samples", "refactor_every")
                      else v)
                  for k, v in kwargs.items()}
        return cls(**kwargs)


class GPMP2Result(NamedTuple):
    trajs: torch.Tensor          # (..., H, 2d) optimized trajectories
    costs: torch.Tensor          # (...) final collision costs
    cost_trace: torch.Tensor     # (opt_iters, ...) cost per iteration


def gpmp2_init_trajs(generator: torch.Generator, params: GPMP2Params,
                     start_state, goal_state,
                     num_samples: Optional[int] = None):
    """Initial trajectories sampled from the endpoint-conditioned GP prior
    (``sample_gp_prior_trajs``) -> (num_samples, H, 2d)."""
    n = params.num_samples if num_samples is None else num_samples
    return sample_gp_prior_trajs(
        generator, start_state, goal_state, params.n_support_points, n,
        params.dt, params.sigma_gp_init)


def _lanes_gn_system(lanes_terms, theta, start_state, goal_state,
                     params: GPMP2Params, ee_goal_terms=None):
    """GN system for theta (B, H, m) in the solver layout:
    (b_l (H, m, B), D_l (H, m, m, B), U_l (H, m, m, 1), cost_traj (B,)).
    Waypoint lanes are h-major (n = h * B + b).  ``ee_goal_terms`` adds its
    gradient and Hessian to the last block in place (D_l stays the one
    contiguous tensor the sum makes)."""
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
    if ee_goal_terms is not None:
        g_ee, H_ee, _ = ee_goal_terms(theta[..., -1, :d])   # (B,m), (B,m,m)
        b_l[-1] -= g_ee.T
        D_l[-1] += H_ee.permute(1, 2, 0)
    U_l = torch.cat([U, torch.zeros_like(U[:1])])[..., None].contiguous()
    return b_l, D_l, U_l, torch.sum(cost, dim=0)


def _obstacle_terms(residual_fn, q, d_state: int, lam: float):
    """Hinge-residual GN terms of q (..., d), batch-major: gradient
    (..., m), Hessian blocks (..., m, m) in the position part of the state
    m = ``d_state``, cost 0.5 lam sum r^2 (...).  ``residual_fn`` maps
    q (d,) -> r (P,) (a batch in one call where it ``supports_batch``); its
    ``residuals_and_jacobian``, where it carries one, gives the Jacobians,
    else ``torch.func.vmap(torch.func.jacfwd(residual_fn))``."""
    d = q.shape[-1]
    q_flat = q.reshape(-1, d)
    raj = getattr(residual_fn, "residuals_and_jacobian", None)
    if raj is not None:
        r_flat, J_flat = (raj(q_flat) if getattr(raj, "supports_batch", False)
                          else torch.func.vmap(raj)(q_flat))
    else:
        r_flat = (residual_fn(q_flat)
                  if getattr(residual_fn, "supports_batch", False)
                  else torch.func.vmap(residual_fn)(q_flat))
        J_flat = torch.func.vmap(torch.func.jacfwd(residual_fn))(q_flat)
    r = r_flat.reshape(q.shape[:-1] + r_flat.shape[-1:])
    J = J_flat.reshape(q.shape[:-1] + J_flat.shape[-2:])
    kw = dict(dtype=q.dtype, device=q.device)
    g = torch.zeros(q.shape[:-1] + (d_state,), **kw)
    Hb = torch.zeros(q.shape[:-1] + (d_state, d_state), **kw)
    g[..., :d] = lam * torch.einsum("...pi,...p->...i", J, r)
    Hb[..., :d, :d] = lam * torch.einsum("...pi,...pj->...ij", J, J)
    cost = 0.5 * lam * torch.sum(torch.square(r), dim=-1)
    return g, Hb, cost


def _lanes_layout(D, U, b):
    """Batch-major D (..., H, m, m), shared U (H-1, m, m), b (..., H, m)
    -> the lanes layout (D_l (H, m, m, B), U_l (H, m, m, 1), b_l (H, m, B))
    with the batch flattened into B lanes."""
    H, m = b.shape[-2], b.shape[-1]
    batch = b.shape[:-2]
    D_l = D.expand(batch + (H, m, m)).reshape(-1, H, m, m).permute(
        1, 2, 3, 0).contiguous()
    U_l = torch.cat([U, torch.zeros_like(U[:1])])[..., None].contiguous()
    b_l = b.reshape(-1, H, m).permute(1, 2, 0).contiguous()
    return D_l, U_l, b_l


def _solve_generic(D, U, b):
    """The generic step's solve: D (..., H, m, m), U (H-1, m, m) shared,
    b (..., H, m) -> x (..., H, m).  For m <= 32 the batch is flattened
    into lanes (``solve_lanes_auto``), else it is solved batch-major."""
    from ..ops.btridiag_kernel import solve_lanes_auto
    from .btridiag import block_tridiag_solve
    if b.shape[-1] > _LANES_SOLVE_MAX_M:
        return block_tridiag_solve(D, U, b)
    x_l = solve_lanes_auto(*_lanes_layout(D, U, b))               # (H, m, B)
    return x_l.permute(2, 0, 1).reshape(b.shape)


def _generic_gn_system(residual_fn, theta, start_state, goal_state,
                       params: GPMP2Params, ee_goal_terms=None):
    """The generic step's GN system for theta (..., H, m), batch-major:
    (g (..., H, m), D (..., H, m, m), U (H-1, m, m), collision cost per
    trajectory (...)); the step solves D x = -g."""
    m = theta.shape[-1]
    d = m // 2
    g_gp, D, U = gp_prior_terms(
        theta, start_state, goal_state, params.dt, params.sigma_start,
        params.sigma_gp, params.sigma_goal_prior)
    lam = 1.0 / (params.sigma_coll ** 2)
    g_obs, H_obs, cost_obs = _obstacle_terms(residual_fn, theta[..., :d], m,
                                             lam)
    g = g_gp + g_obs
    D = D + H_obs + params.solver_delta * torch.eye(
        m, dtype=theta.dtype, device=theta.device)
    if ee_goal_terms is not None:
        g_ee, H_ee, _ = ee_goal_terms(theta[..., -1, :d])
        g[..., -1, :] += g_ee
        D[..., -1, :, :] += H_ee
    return g, D, U, torch.sum(cost_obs, dim=-1)


def _gpmp2_step_impl(residual_fn, theta, start_state, goal_state,
                     params: GPMP2Params, ee_goal_terms=None):
    """The generic GN step (module doc): theta (..., H, m) -> (theta_next,
    collision cost per trajectory (...))."""
    g, D, U, cost = _generic_gn_system(residual_fn, theta, start_state,
                                       goal_state, params, ee_goal_terms)
    return theta + params.step_size * _solve_generic(D, U, -g), cost


def gpmp2_step(residual_fn: Callable, theta, start_state, goal_state,
               params: GPMP2Params, ee_goal_terms: Callable = None):
    """One Gauss-Newton step over a batch of trajectories theta (..., H, m):
    the lanes step for theta (B, H, m) and a ``residual_fn`` that carries
    ``obstacle_terms_lanes`` (a PlanningTask's ``collision_residuals``),
    the generic step otherwise (module doc); ``ee_goal_terms`` (optional)
    an EE-pose goal factor on the final waypoint.  Returns (theta_next,
    collision cost per trajectory (...))."""
    lanes_terms = getattr(residual_fn, "obstacle_terms_lanes", None)
    if lanes_terms is None or theta.dim() != 3:
        return _gpmp2_step_impl(residual_fn, theta, start_state, goal_state,
                                params, ee_goal_terms)
    from ..ops.btridiag_kernel import solve_lanes_auto
    b_l, D_l, U_l, cost_traj = _lanes_gn_system(
        lanes_terms, theta, start_state, goal_state, params, ee_goal_terms)
    x_l = solve_lanes_auto(D_l, U_l, b_l)                        # (H, m, B)
    theta_next = theta + params.step_size * x_l.permute(2, 0, 1)
    return theta_next, cost_traj


def gpmp2_solve(residual_fn: Callable, theta0, start_state, goal_state,
                params: GPMP2Params,
                ee_goal_terms: Callable = None) -> GPMP2Result:
    """``params.opt_iters`` Gauss-Newton steps (``gpmp2_step``) from theta0
    (..., H, m) (e.g. from ``gpmp2_init_trajs``), with an optional EE-pose
    goal factor; ``refactor_every`` > 1 takes the reuse schedule of the
    module doc."""
    if params.refactor_every > 1 and theta0.dim() == 3:
        lanes_terms = getattr(residual_fn, "obstacle_terms_lanes", None)
        m = theta0.shape[-1]
        if lanes_terms is not None and m <= _REUSE_MAX_M:
            return _gpmp2_solve_reuse(lanes_terms, theta0, start_state,
                                      goal_state, params, ee_goal_terms)
        warnings.warn("refactor_every=%d is ignored: factorization reuse "
                      "takes lanes terms and m <= %d (m = %d)"
                      % (params.refactor_every, _REUSE_MAX_M, m))
    theta, costs = theta0, []
    for _ in range(params.opt_iters):
        theta, cost = gpmp2_step(residual_fn, theta, start_state, goal_state,
                                 params, ee_goal_terms)
        costs.append(cost)
    cost_trace = torch.stack(costs)
    return GPMP2Result(trajs=theta, costs=cost_trace[-1],
                       cost_trace=cost_trace)


def _gpmp2_solve_reuse(lanes_terms, theta0, start_state, goal_state,
                       params: GPMP2Params,
                       ee_goal_terms=None) -> GPMP2Result:
    """GN solve with factorization reuse (module doc): the factor sweep on
    iterations 0, k, 2k, ..., the substitution sweep against its stale
    factors on the others."""
    from ..ops.btridiag_kernel import solve_lanes_factor, solve_lanes_subst
    theta, L, W, costs = theta0, None, None, []
    for it in range(params.opt_iters):
        b_l, D_l, U_l, cost_traj = _lanes_gn_system(
            lanes_terms, theta, start_state, goal_state, params,
            ee_goal_terms)
        if it % params.refactor_every == 0:
            x_l, L, W = solve_lanes_factor(D_l, U_l, b_l)
        else:
            x_l = solve_lanes_subst(L, W, b_l)
        theta = theta + params.step_size * x_l.permute(2, 0, 1)
        costs.append(cost_traj)
    cost_trace = torch.stack(costs)
    return GPMP2Result(trajs=theta, costs=cost_trace[-1],
                       cost_trace=cost_trace)


def gpmp2_solve_restarts(residual_fn: Callable, theta0, start_state,
                         goal_state, params: GPMP2Params, free_fn: Callable,
                         generator: torch.Generator,
                         ee_goal_terms: Callable = None,
                         restart_rounds: int = 1,
                         restart_iters: Optional[int] = None) -> GPMP2Result:
    """GPMP2 with random restarts of the trajectories that end in
    collision.

    After the main solve, each round re-initializes the trajectories that
    ``free_fn`` (e.g. ``lambda t: ~task.trajs_collision_masks(t)[0]``)
    flags as not free with fresh GP-prior samples (drawn from
    ``generator``) and re-solves the whole batch for ``restart_iters``
    iterations (default opt_iters // 2), adopting the results only for
    those lanes: free solutions are kept bit for bit.  Every solve takes
    the optional EE-pose goal factor.  ``cost_trace`` is the main
    solve's."""
    res = gpmp2_solve(residual_fn, theta0, start_state, goal_state, params,
                      ee_goal_terms)
    trajs, costs = res.trajs, res.costs
    B = theta0.shape[0]
    it_r = (max(params.opt_iters // 2, 1) if restart_iters is None
            else int(restart_iters))
    p_r = dataclasses.replace(params, opt_iters=it_r)
    for _ in range(max(int(restart_rounds), 0)):
        free = free_fn(trajs)
        theta_new = sample_gp_prior_trajs(
            generator, start_state, goal_state, params.n_support_points, B,
            params.dt, params.sigma_gp_init)
        theta_init = torch.where(free[:, None, None], trajs, theta_new)
        res_r = gpmp2_solve(residual_fn, theta_init, start_state, goal_state,
                            p_r, ee_goal_terms)
        trajs = torch.where(free[:, None, None], trajs, res_r.trajs)
        costs = torch.where(free, costs, res_r.costs)
    return GPMP2Result(trajs=trajs, costs=costs, cost_trace=res.cost_trace)


def gpmp2_solve_adaptive(residual_fn: Callable, theta0, start_state,
                         goal_state, params: GPMP2Params,
                         ee_goal_terms: Callable = None):
    """Gauss-Newton with early exit on ``params.stop_criteria``: at most
    ``opt_iters`` steps, stopping as soon as every trajectory's relative
    cost change |c_prev - c| / max(|c_prev|, 1e-10) is at most the
    criterion (finite sentinels force the first two steps).  A host loop
    that reads the test after every step.  ``stop_criteria <= 0`` runs the
    fixed-count solve.  -> (trajs, costs, n_iters run)."""
    if params.stop_criteria <= 0.0:
        res = gpmp2_solve(residual_fn, theta0, start_state, goal_state,
                          params, ee_goal_terms)
        return res.trajs, res.costs, params.opt_iters
    batch = theta0.shape[:-2]
    kw = dict(dtype=theta0.dtype, device=theta0.device)
    cost_prev = torch.full(batch, 1e10, **kw)
    cost = torch.zeros(batch, **kw)
    theta, n_iters = theta0, 0
    while n_iters < params.opt_iters:
        rel = ((cost_prev - cost).abs()
               / torch.clamp(cost_prev.abs(), min=1e-10))
        if not bool((rel > params.stop_criteria).any()):
            break
        theta, cost_next = gpmp2_step(residual_fn, theta, start_state,
                                      goal_state, params, ee_goal_terms)
        cost_prev, cost = cost, cost_next
        n_iters += 1
    return theta, cost, n_iters
