"""Constant-velocity Gauss-Markov (GP) trajectory prior (counterpart of
torch_robotics_tpu/solve/gp_prior.py).

States x_t = [q_t, qd_t] follow a constant-velocity model: consecutive
states are tied by Phi(dt) with process noise Q(dt), Qc = sigma_gp^2 I.
The prior's Hessian is block-tridiagonal and state-independent.

The exact prior sampler builds the endpoint-conditioned bridge's precision
and factors it host-side in float64 numpy (everything there is static);
applying the factor is one matrix product.  The port draws its standard
normals from a ``torch.Generator`` where the reference splits a key, so the
map from given normals to trajectories, ``gp_prior_trajs_from_normals``,
is a function of its own: the tests feed both packages the same normals.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["gp_transition", "gp_Q_inv", "gp_prior_blocks", "gp_prior_terms",
           "straight_line_trajs", "gp_bridge_mean_matrices",
           "gp_bridge_mean", "gp_bridge_sampler_matrix",
           "gp_prior_trajs_from_normals", "sample_gp_prior_trajs"]


def gp_transition(d: int, dt: float, dtype=torch.float32, device="cuda"):
    """Phi = [[I, dt I], [0, I]] for x = [q, qd]."""
    device = resolve_device(device)
    eye = torch.eye(d, dtype=dtype, device=device)
    zero = torch.zeros((d, d), dtype=dtype, device=device)
    return torch.cat([torch.cat([eye, dt * eye], 1),
                      torch.cat([zero, eye], 1)], 0)


def gp_Q_inv(d: int, dt: float, sigma_gp: float, dtype=torch.float32,
             device="cuda"):
    """Q^-1 = [[12/dt^3, -6/dt^2], [-6/dt^2, 4/dt]] (x) Qc^-1."""
    qc_inv = 1.0 / (sigma_gp ** 2)
    eye = torch.eye(d, dtype=dtype, device=resolve_device(device))
    a = 12.0 / dt ** 3 * qc_inv
    b = -6.0 / dt ** 2 * qc_inv
    c = 4.0 / dt * qc_inv
    return torch.cat([torch.cat([a * eye, b * eye], 1),
                      torch.cat([b * eye, c * eye], 1)], 0)


def gp_prior_blocks(d: int, H: int, dt: float, sigma_start: float,
                    sigma_gp: float, sigma_goal: float, dtype=torch.float32,
                    device="cuda"):
    """Static block-tridiagonal Hessian of the GP factor graph:
    (D (H, m, m), U (H-1, m, m))."""
    m = 2 * d
    device = resolve_device(device)
    Phi = gp_transition(d, dt, dtype, device)
    Qi = gp_Q_inv(d, dt, sigma_gp, dtype, device)
    PhiT_Qi = Phi.T @ Qi
    PhiT_Qi_Phi = PhiT_Qi @ Phi
    eye_m = torch.eye(m, dtype=dtype, device=device)
    ks = 1.0 / (sigma_start ** 2)
    kg = 1.0 / (sigma_goal ** 2)
    first = PhiT_Qi_Phi + ks * eye_m
    mid = PhiT_Qi_Phi + Qi
    last = Qi + kg * eye_m
    D = torch.cat([first[None], mid[None].expand(H - 2, m, m), last[None]])
    U = (-PhiT_Qi)[None].expand(H - 1, m, m).contiguous()
    return D, U


def gp_prior_terms(theta, start_state, goal_state, dt, sigma_start, sigma_gp,
                   sigma_goal):
    """Gradient and block-tridiagonal Hessian blocks of the GP factor graph
    for theta (..., H, 2d): (g (..., H, 2d), D (H, m, m), U (H-1, m, m)).

    Quadratic form 0.5 ||x_0 - start||^2_Ks + 0.5 sum ||x_{t+1} - Phi
    x_t||^2_Qinv + 0.5 ||x_{H-1} - goal||^2_Kg."""
    H, m = theta.shape[-2], theta.shape[-1]
    d = m // 2
    kw = dict(dtype=theta.dtype, device=theta.device)
    Phi = gp_transition(d, dt, **kw)
    Qi = gp_Q_inv(d, dt, sigma_gp, **kw)

    e = theta[..., 1:, :] - theta[..., :-1, :] @ Phi.T
    Qi_e = e @ Qi.T
    neg_PhiT_Qi_e = -(Qi_e @ Phi)
    zeros1 = torch.zeros_like(theta[..., :1, :])
    g = (torch.cat([neg_PhiT_Qi_e, zeros1], dim=-2)
         + torch.cat([zeros1, Qi_e], dim=-2))
    ks = 1.0 / (sigma_start ** 2)
    kg = 1.0 / (sigma_goal ** 2)
    g0 = g[..., :1, :] + ks * (theta[..., :1, :] - start_state[..., None, :])
    gH = g[..., -1:, :] + kg * (theta[..., -1:, :] - goal_state[..., None, :])
    g = torch.cat([g0, g[..., 1:-1, :], gH], dim=-2)
    D, U = gp_prior_blocks(d, H, dt, sigma_start, sigma_gp, sigma_goal, **kw)
    return g, D, U


def straight_line_trajs(start_state, goal_state, H: int, dt: float = None):
    """Constant-velocity straight line between state endpoints:
    (..., 2d) -> (..., H, 2d).  Velocities are dq/((H-1) dt); dt=None keeps
    the per-step convention dq/(H-1)."""
    m = start_state.shape[-1]
    d = m // 2
    w = torch.linspace(0.0, 1.0, H, dtype=start_state.dtype,
                       device=start_state.device)
    pos = (start_state[..., None, :d] * (1.0 - w)[:, None]
           + goal_state[..., None, :d] * w[:, None])
    step_t = (H - 1) * dt if dt is not None else (H - 1)
    vel = ((goal_state[..., None, :d] - start_state[..., None, :d])
           / step_t).expand(pos.shape)
    return torch.cat([pos, vel], dim=-1)


def _gp_bridge_precision(d: int, H: int, dt: float, sigma_gp: float,
                         sigma_endpoint: float):
    """Dense (n, n) float64 numpy precision of the endpoint-conditioned
    constant-velocity GP prior (transition factors + endpoint state
    priors), n = H * 2d, and the endpoint weight 1/sigma_endpoint^2."""
    m = 2 * d
    eye = np.eye(d)
    Phi = np.block([[eye, dt * eye], [np.zeros((d, d)), eye]])
    qc_inv = 1.0 / float(sigma_gp) ** 2
    Qi = np.block([[12.0 / dt ** 3 * eye, -6.0 / dt ** 2 * eye],
                   [-6.0 / dt ** 2 * eye, 4.0 / dt * eye]]) * qc_inv
    PtQ = Phi.T @ Qi
    P = np.zeros((H, m, H, m))
    for t in range(H - 1):
        P[t, :, t, :] += PtQ @ Phi
        P[t + 1, :, t + 1, :] += Qi
        P[t, :, t + 1, :] -= PtQ
        P[t + 1, :, t, :] -= PtQ.T
    ke = 1.0 / float(sigma_endpoint) ** 2
    P[0, :, 0, :] += ke * np.eye(m)
    P[-1, :, -1, :] += ke * np.eye(m)
    return P.reshape(H * m, H * m), ke


@functools.lru_cache(maxsize=32)
def _bridge_mean_np(d, H, dt, sigma_gp, sigma_endpoint):
    m = 2 * d
    P, ke = _gp_bridge_precision(d, H, dt, sigma_gp, sigma_endpoint)
    Pinv = np.linalg.inv(P)
    return ke * Pinv[:, :m], ke * Pinv[:, -m:]


@functools.lru_cache(maxsize=32)
def _bridge_sampler_np(d, H, dt, sigma_gp, sigma_endpoint):
    P, _ = _gp_bridge_precision(d, H, dt, sigma_gp, sigma_endpoint)
    return np.linalg.inv(np.linalg.cholesky(P)).T      # upper triangular


def gp_bridge_mean_matrices(d: int, H: int, dt: float, sigma_gp: float,
                            sigma_endpoint: float = 1e-5,
                            dtype=torch.float32, device="cuda"):
    """(W_s, W_g), each (H*2d, 2d): the conditioned GP prior mean is
    ``start @ W_s.T + goal @ W_g.T`` reshaped (..., H, 2d), the
    minimum-GP-energy trajectory between the endpoint states."""
    dev = resolve_device(device)
    # torch.tensor copies: the cached arrays are never shared with callers
    return tuple(torch.tensor(a, dtype=dtype, device=dev)
                 for a in _bridge_mean_np(d, H, float(dt), float(sigma_gp),
                                          float(sigma_endpoint)))


def gp_bridge_mean(start_state, goal_state, H: int, dt: float,
                   sigma_gp: float, sigma_endpoint: float = 1e-5):
    """Conditioned GP prior mean trajectories: (..., 2d) -> (..., H, 2d)."""
    d = start_state.shape[-1] // 2
    W_s, W_g = gp_bridge_mean_matrices(d, H, dt, sigma_gp, sigma_endpoint,
                                       start_state.dtype, start_state.device)
    mu = start_state @ W_s.T + goal_state @ W_g.T
    return mu.reshape(start_state.shape[:-1] + (H, 2 * d))


def gp_bridge_sampler_matrix(d: int, H: int, dt: float, sigma_gp: float,
                             sigma_endpoint: float = 1e-5,
                             dtype=torch.float32, device="cuda"):
    """M (n, n), n = H*2d, upper triangular, such that ``xi @ M.T`` with
    xi ~ N(0, I) is distributed N(0, P^-1), P the bridge's precision:
    M = L^-T with P = L L^T, factored host-side in float64."""
    return torch.tensor(
        _bridge_sampler_np(d, H, float(dt), float(sigma_gp),
                           float(sigma_endpoint)),
        dtype=dtype, device=resolve_device(device))


def gp_prior_trajs_from_normals(xi, start_state, goal_state, H: int,
                                dt: float, sigma_gp_init: float):
    """Prior samples from given standard normals xi (n_samples, H*2d):
    conditioned mean + xi M^T, reshaped (n_samples, H, 2d) and broadcast
    against the endpoints' batch dims, as the reference broadcasts them."""
    m = start_state.shape[-1]
    mean = gp_bridge_mean(start_state, goal_state, H, dt, sigma_gp_init)
    M = gp_bridge_sampler_matrix(m // 2, H, dt, sigma_gp_init,
                                 dtype=mean.dtype, device=mean.device)
    noise = (xi.to(mean.dtype) @ M.T).reshape((xi.shape[0], H, m))
    return mean + noise


def sample_gp_prior_trajs(generator: torch.Generator, start_state,
                          goal_state, H: int, num_samples: int, dt: float,
                          sigma_gp_init: float):
    """Exact samples of the endpoint-conditioned GP prior: start/goal
    (..., 2d) -> (num_samples, H, 2d) (or the endpoints' batch when they
    carry one, num_samples = B giving one sample per problem).  The
    normals are drawn on ``generator``'s device and moved to the
    endpoints', so one CPU generator gives the same samples to a card run
    and a CPU run."""
    m = start_state.shape[-1]
    xi = torch.randn((num_samples, H * m), generator=generator,
                     dtype=start_state.dtype, device=generator.device)
    return gp_prior_trajs_from_normals(xi.to(start_state.device),
                                       start_state, goal_state, H, dt,
                                       sigma_gp_init)
