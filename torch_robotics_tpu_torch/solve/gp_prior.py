"""Constant-velocity Gauss-Markov (GP) trajectory prior (counterpart of
``gp_prior_terms`` and ``straight_line_trajs`` in
torch_robotics_tpu/solve/gp_prior.py).

States x_t = [q_t, qd_t] follow a constant-velocity model: consecutive
states are tied by Phi(dt) with process noise Q(dt), Qc = sigma_gp^2 I.
The prior's Hessian is block-tridiagonal and state-independent.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device

__all__ = ["gp_transition", "gp_Q_inv", "gp_prior_blocks", "gp_prior_terms",
           "straight_line_trajs"]


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
