"""Sampling-based trajectory optimizer: MPPI-style stochastic GPMP (sGPMP),
the counterpart of torch_robotics_tpu/solve/sampling.py.

Per iteration: draw K smooth perturbations of the current mean
trajectories from the endpoint-conditioned GP bridge (one matrix product
with the exact sampler matrix), score every candidate by collision + GP
prior energy, average the perturbations with softmax weights on the
spread-normalized costs, and accept the averaged step only where it lowers
a problem's cost.  Everything is batched over independent problems.

Candidates are scored by cost value only: where the task's residual
function carries ``collision_cost_lanes`` (the value-only cost kernel, its
MultiRobot variant for a ``MultiRobot``) the scoring goes through it;
otherwise through the residual values.  The port draws its standard normals
from a ``torch.Generator`` where the reference splits a key, so the map
from given normals to the result, ``sgpmp_solve_normals``, is an entry of
its own: the tests feed both packages the same normals.  The product of
the normals with the sampler matrix is ``torch.matmul`` (the reference
leaves it to XLA); float32 products run in full precision (the tasks turn
TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .gp_prior import gp_bridge_sampler_matrix, gp_Q_inv, gp_transition

__all__ = ["SGPMPParams", "SGPMPResult", "sgpmp_solve", "sgpmp_solve_normals"]


@dataclasses.dataclass(frozen=True)
class SGPMPParams:
    n_support_points: int = 64
    dt: float = 0.04
    opt_iters: int = 100
    num_samples: int = 64
    sigma_start: float = 1e-5
    sigma_gp: float = 1e-2
    sigma_goal_prior: float = 1e-5
    sigma_coll: float = 1e-5
    #: Scale-free softmax temperature: sample weights are
    #: ``softmax(-(c - min c) / (temperature * std(c)))`` over the K samples,
    #: so it is measured in units of the per-iteration cost spread.
    temperature: float = 1.0
    #: process-noise scale of the perturbation prior (not the cost's sigma_gp)
    sigma_gp_sample: float = 0.2
    #: per-iteration multiplier on the perturbation scale; 1.0 = constant
    anneal: float = 1.0
    step_size: float = 0.5

    @classmethod
    def from_preset(cls, preset: dict) -> "SGPMPParams":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in preset.items() if k in known}
        kwargs = {k: (int(v) if k in ("n_support_points", "opt_iters",
                                      "num_samples") else v)
                  for k, v in kwargs.items()}
        return cls(**kwargs)


class SGPMPResult(NamedTuple):
    trajs: torch.Tensor          # (..., H, 2d) final mean trajectories
    cost_trace: torch.Tensor     # (opt_iters, ...) mean-trajectory costs


def _gp_energy(theta, start_state, goal_state, params: SGPMPParams):
    """GP prior energy of theta (..., H, 2d) -> (...): the transition
    factors plus the start and goal state priors."""
    d = theta.shape[-1] // 2
    kw = dict(dtype=theta.dtype, device=theta.device)
    Phi = gp_transition(d, params.dt, **kw)
    Qi = gp_Q_inv(d, params.dt, params.sigma_gp, **kw)
    e = theta[..., 1:, :] - theta[..., :-1, :] @ Phi.T
    E = 0.5 * torch.sum((e @ Qi) * e, dim=(-2, -1))
    E = E + 0.5 / params.sigma_start ** 2 * torch.sum(
        torch.square(theta[..., 0, :] - start_state), dim=-1)
    return E + 0.5 / params.sigma_goal_prior ** 2 * torch.sum(
        torch.square(theta[..., -1, :] - goal_state), dim=-1)


def _total_cost_fn(residual_fn: Callable, start_state, goal_state,
                   params: SGPMPParams):
    """theta (..., H, 2d) -> collision + GP prior cost (...)."""
    lam = 1.0 / (params.sigma_coll ** 2)
    batched = getattr(residual_fn, "supports_batch", False)
    cost_lanes = getattr(residual_fn, "collision_cost_lanes", None)

    def total_cost(theta):
        d = theta.shape[-1] // 2
        q_flat = theta[..., :d].reshape(-1, d)
        if cost_lanes is not None:
            c = cost_lanes(q_flat.T.contiguous())
            coll = lam * torch.sum(c.reshape(theta.shape[:-2] + (-1,)),
                                   dim=-1)
        else:
            r = (residual_fn(q_flat) if batched
                 else torch.vmap(residual_fn)(q_flat))
            coll = 0.5 * lam * torch.sum(
                torch.square(r).reshape(theta.shape[:-2] + (-1,)), dim=-1)
        return coll + _gp_energy(theta, start_state, goal_state, params)

    return total_cost


def _sgpmp_step(total_cost, theta, cost, xi, M_sample, scale: float,
                params: SGPMPParams):
    """One iteration from the normals xi (K, ..., H 2d) -> (theta, cost,
    the K candidates' costs (K, ...))."""
    K = xi.shape[0]
    noise = scale * (xi @ M_sample.T).reshape((K,) + theta.shape)
    costs = total_cost(theta[None] + noise)                  # (K, ...)
    spread = costs.std(dim=0, keepdim=True, correction=0) + 1e-12
    w = torch.softmax(-(costs - costs.amin(dim=0, keepdim=True))
                      / (params.temperature * spread), dim=0)
    delta = torch.sum(w[..., None, None] * noise, dim=0)
    prop = theta + params.step_size * delta
    cost_prop = total_cost(prop)
    # monotone acceptance per problem: the MPPI average can point uphill
    accept = cost_prop < cost
    theta = torch.where(accept[..., None, None], prop, theta)
    cost = torch.where(accept, cost_prop, cost)
    return theta, cost, costs


def _solve(residual_fn, theta0, start_state, goal_state,
           params: SGPMPParams, normals: Callable) -> SGPMPResult:
    m = theta0.shape[-1]
    H = theta0.shape[-2]
    total_cost = _total_cost_fn(residual_fn, start_state, goal_state, params)
    M_sample = gp_bridge_sampler_matrix(m // 2, H, params.dt,
                                        params.sigma_gp_sample,
                                        dtype=theta0.dtype,
                                        device=theta0.device)
    theta, cost = theta0, total_cost(theta0)
    trace = []
    for t in range(params.opt_iters):
        theta, cost, _ = _sgpmp_step(total_cost, theta, cost, normals(t),
                                     M_sample, params.anneal ** t, params)
        trace.append(cost)
    return SGPMPResult(trajs=theta, cost_trace=torch.stack(trace))


def sgpmp_solve_normals(residual_fn: Callable, theta0, start_state,
                        goal_state, params: SGPMPParams,
                        xi) -> SGPMPResult:
    """sGPMP from given standard normals: theta0 (..., H, 2d) initial mean
    trajectories, start/goal (..., 2d), xi (opt_iters, K, ..., H 2d) (any
    object whose ``xi[t]`` is iteration t's normals on theta0's device)."""
    return _solve(residual_fn, theta0, start_state, goal_state, params,
                  lambda t: xi[t].to(theta0.dtype))


def sgpmp_solve(residual_fn: Callable, theta0, start_state, goal_state,
                params: SGPMPParams,
                generator: Optional[torch.Generator] = None) -> SGPMPResult:
    """sGPMP with each iteration's normals drawn from ``generator`` (on its
    own device, then moved to theta0's; None: a generator on theta0's
    device seeded 0, as the reference defaults to key 0).  theta0 (..., H,
    2d), start/goal (..., 2d) -> SGPMPResult."""
    if generator is None:
        generator = torch.Generator(device=theta0.device).manual_seed(0)
    shape = (params.num_samples,) + theta0.shape[:-2] + (
        theta0.shape[-2] * theta0.shape[-1],)

    def normals(t):
        return torch.randn(shape, generator=generator, dtype=theta0.dtype,
                           device=generator.device).to(theta0.device)

    return _solve(residual_fn, theta0, start_state, goal_state, params,
                  normals)
