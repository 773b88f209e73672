"""Batched iLQR trajectory optimizer on constant-velocity dynamics
(counterpart of torch_robotics_tpu/solve/ilqr.py).

States x_t = [q_t, qd_t] follow the double integrator
x_{t+1} = Phi x_t + B u_t exactly (u = joint acceleration), so every
trajectory is dynamically feasible by construction.  Each iteration runs a
square-root Riccati backward sweep and rolls all line-search step sizes
out in one batched pass, picking the best step PER problem.  Batch-first:
every residual / Jacobian evaluation is one call over the flattened
(B (H - 1), d) waypoint batch.

Cost model (GPMP2's factors, so presets transfer): hinge obstacle
residuals (sigma_coll), control effort (r_control), terminal goal prior
(sigma_goal_prior), optional running goal-position pull
(sigma_goal_running) and joint-limit hinges (sigma_limits with q_limits).

``ILQRParams.riccati`` picks the sweeps:

- ``"kernel"`` (default; the counterpart of the reference's ``"pallas"``):
  the CUDA Riccati sweep and line-search rollout kernels
  (``ops/riccati_kernel.py``) for CUDA tensors, their plain versions for
  CPU tensors, as the reference runs its lanes sweeps off the TPU;
- ``"lanes"``: the plain versions (``solve/riccati_lanes.py``) on every
  device;
- ``"qr"``: batched ``torch.linalg.qr`` inside the sweep and a
  matrix-form rollout, the independent reference form.

The line search scores candidates with the task's value-only collision
cost (``collision_cost_lanes``: the CUDA cost kernel for CUDA tensors) in
every mode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..core.device import disable_tf32
from .riccati_lanes import (dynamics_mats, linesearch_rollout_lanes,
                            riccati_backward_lanes, riccati_backward_qr)

__all__ = ["ILQRParams", "ILQRResult", "ilqr_solve"]


@dataclasses.dataclass(frozen=True)
class ILQRParams:
    n_support_points: int = 64
    dt: float = 0.04
    opt_iters: int = 50
    sigma_coll: float = 1e-2
    sigma_goal_prior: float = 1e-2
    # running goal-POSITION pull toward the reference (0.0 disables): makes
    # a receding-horizon loop that executes the first control contractive
    sigma_goal_running: float = 0.0
    # joint-limit hinge weight (0.0 disables), active only when ilqr_solve
    # gets q_limits: 0.5/sigma^2 (relu(q - q_max)^2 + relu(q_min - q)^2)
    sigma_limits: float = 0.0
    r_control: float = 1e-4          # control-effort weight (R = r I)
    mu: float = 1e-6                 # Levenberg regularization on Q_uu
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)   # line-search step sizes
    riccati: str = "kernel"          # "kernel" | "lanes" | "qr" (module doc)


class ILQRResult(NamedTuple):
    trajs: torch.Tensor       # (..., H, 2d) optimized state trajectories
    controls: torch.Tensor    # (..., H-1, d) optimized accelerations
    costs: torch.Tensor       # (...) final total costs
    cost_trace: torch.Tensor  # (opt_iters, ...) total cost per iteration


def _rollout(x0, U_t, Phi, Bm):
    """x0 (B, m), U_t (H-1, B, d) time-major -> states (B, H, m)."""
    xs = [x0]
    for u in U_t:
        xs.append(xs[-1] @ Phi.T + u @ Bm.T)
    return torch.stack(xs, dim=1)


def _ilqr_batch(residual_fn, x0, goal_state, params: ILQRParams,
                u_init=None, x_ref=None, q_limits=None):
    """Batch-first iLQR on x0 / goal (B, m) (module doc)."""
    if params.riccati not in ("kernel", "lanes", "qr"):
        raise ValueError("riccati must be 'kernel', 'lanes' or 'qr', got %r"
                         % (params.riccati,))
    B, m = x0.shape
    d = m // 2
    H = params.n_support_points
    T = H - 1
    dtype, dev = x0.dtype, x0.device
    kw = dict(dtype=dtype, device=dev)
    refs = (goal_state[:, None].expand(B, H, m) if x_ref is None
            else x_ref)
    Phi, Bm = dynamics_mats(d, params.dt, dtype, dev)

    lam = 1.0 / (params.sigma_coll ** 2)
    kg = 1.0 / (params.sigma_goal_prior ** 2)
    kr = (0.0 if params.sigma_goal_running == 0.0
          else 1.0 / (params.sigma_goal_running ** 2))
    kl = (0.0 if params.sigma_limits == 0.0 or q_limits is None
          else 1.0 / (params.sigma_limits ** 2))
    if kl:
        q_lo, q_hi = (torch.as_tensor(v, **kw) for v in q_limits)
    r = params.r_control
    sqrt_kr = kr ** 0.5
    sqrt_kl = kl ** 0.5
    dt_ = params.dt

    raj = getattr(residual_fn, "residuals_and_jacobian", None)
    raj_batched = raj is not None and getattr(raj, "supports_batch", False)
    res_batched = getattr(residual_fn, "supports_batch", False)

    def batch_residuals(q_flat):
        return (residual_fn(q_flat) if res_batched
                else torch.func.vmap(residual_fn)(q_flat))

    # the line search needs cost VALUES only: the value-only cost kernel
    cost_lanes = getattr(residual_fn, "collision_cost_lanes", None)

    def batch_coll_cost(q):
        """q (..., H-1, d) -> 0.5 * sum_p r^2 summed over waypoints."""
        if cost_lanes is not None:
            c = cost_lanes(q.reshape(-1, d).T.contiguous())
            return torch.sum(c.reshape(q.shape[:-1]), dim=-1)
        res = batch_residuals(q.reshape(-1, d)).reshape(q.shape[:-1] + (-1,))
        return 0.5 * torch.sum(res * res, dim=(-1, -2))

    def batch_raj(q_flat):
        if raj is not None:
            return (raj(q_flat) if raj_batched
                    else torch.func.vmap(raj)(q_flat))
        return batch_residuals(q_flat), torch.func.vmap(
            torch.func.jacfwd(residual_fn))(q_flat)

    def total_cost(xs, U):
        """xs (..., H, m), U (..., H-1, d) -> (...,) batch costs."""
        q = xs[..., :-1, :d]
        c = lam * batch_coll_cost(q) + 0.5 * r * torch.sum(U * U,
                                                           dim=(-1, -2))
        if kr:
            e = q - refs[..., :-1, :d]
            c = c + 0.5 * kr * torch.sum(e * e, dim=(-1, -2))
        if kl:
            hi, lo = torch.relu(q - q_hi), torch.relu(q_lo - q)
            c = c + 0.5 * kl * torch.sum(hi * hi + lo * lo, dim=(-1, -2))
        e = xs[..., -1, :] - refs[..., -1, :]
        return c + 0.5 * kg * torch.sum(e * e, dim=-1)

    eye_dm = torch.eye(d, m, **kw)

    def running_terms(xs):
        """Gauss-Newton gradient and FACTORED Hessian of the running state
        costs at all (B, H-1) states: lam J^T J = (sqrt(lam) J)^T
        (sqrt(lam) J), so the square-root sweeps never form the
        ill-conditioned product.  -> l_x_T (B, m), l_xs (B, H-1, m),
        F (B, H-1, P_tot, m)."""
        l_x_T = kg * (xs[:, -1] - refs[:, -1])
        q = xs[:, :-1, :d]
        res, J = batch_raj(q.reshape(-1, d))
        P = res.shape[-1]
        res = res.reshape(B, T, P)
        J = J.reshape(B, T, P, d)
        g_q = lam * torch.einsum("bhpd,bhp->bhd", J, res)
        zeros_v = torch.zeros((B, T, m - d), **kw)
        l_xs = torch.cat([g_q, zeros_v], dim=-1)
        F = torch.cat([lam ** 0.5 * J, torch.zeros((B, T, P, m - d), **kw)],
                      dim=-1)
        if kr:
            l_xs = l_xs + kr * torch.cat([q - refs[:, :-1, :d], zeros_v],
                                         dim=-1)
            F = torch.cat([F, (sqrt_kr * eye_dm).expand(B, T, d, m)], dim=-2)
        if kl:
            r_hi, r_lo = torch.relu(q - q_hi), torch.relu(q_lo - q)
            l_xs = l_xs + kl * torch.cat([r_hi - r_lo, zeros_v], dim=-1)
            act = ((r_hi > 0) | (r_lo > 0)).to(dtype)
            F = torch.cat([F, sqrt_kl * act[..., None] * eye_dm], dim=-2)
        return l_x_T, l_xs, F

    def forward_qr(xs, U_t, ks, Ks, alpha):
        """Closed-loop rollout at step size alpha, matrix form; time-major
        inputs -> (xs (B, H, m), U (B, H-1, d))."""
        x = xs[:, 0]
        xs_new, U_new = [x], []
        for t in range(T):
            u = U_t[t] + alpha * ks[t] + torch.einsum(
                "bdm,bm->bd", Ks[t], x - xs[:, t])
            x = x @ Phi.T + u @ Bm.T
            xs_new.append(x)
            U_new.append(u)
        return torch.stack(xs_new, dim=1), torch.stack(U_new, dim=1)

    A = len(params.alphas)
    if params.riccati == "kernel":
        from ..ops.riccati_kernel import (linesearch_rollout_kernel_factory,
                                          riccati_backward_kernel_factory)
        make_sweep = riccati_backward_kernel_factory
        roll = linesearch_rollout_kernel_factory(d, m, T, dt_, params.alphas)
    else:
        make_sweep = riccati_backward_lanes
        roll = linesearch_rollout_lanes(d, m, T, dt_, params.alphas)

    def iteration(xs, U, cost):
        U_t = U.transpose(0, 1)                               # (H-1, B, d)
        l_x_T, l_xs, F = running_terms(xs)
        if params.riccati == "qr":
            ks, Ks = riccati_backward_qr(d, m, F.shape[-2], T, dt_, r,
                                         params.mu, kg)(U_t, l_xs, F, l_x_T)
            rolled = [forward_qr(xs, U_t, ks, Ks, a) for a in params.alphas]
            xs_c = torch.stack([x for x, _ in rolled])        # (A, B, H, m)
            U_c = torch.stack([u for _, u in rolled])
        else:
            U_t_l = U_t.permute(0, 2, 1).contiguous()         # (H-1, d, B)
            sweep = make_sweep(d, m, F.shape[-2], T, dt_, r, params.mu, kg)
            ks_l, Ks_l = sweep(U_t_l, l_xs.permute(1, 2, 0).contiguous(),
                               F.permute(1, 3, 2, 0).contiguous(),
                               l_x_T.T.contiguous())
            xs_l = xs.permute(1, 2, 0).contiguous()           # (H, m, B)
            xs_new, U_c_l = roll(xs_l, U_t_l, ks_l, Ks_l)
            xs_c_l = torch.cat([xs_l[None, :1].expand(A, 1, m, B), xs_new],
                               dim=1)
            xs_c = xs_c_l.permute(0, 3, 1, 2)                 # (A, B, H, m)
            U_c = U_c_l.permute(0, 3, 1, 2)
        costs_c = total_cost(xs_c, U_c)                       # (A, B)
        cost_b, best = torch.min(costs_c, dim=0)
        lanes = torch.arange(B, device=dev)
        xs_b, U_b = xs_c[best, lanes], U_c[best, lanes]
        improved = cost_b < cost                              # (B,)
        return (torch.where(improved[:, None, None], xs_b, xs),
                torch.where(improved[:, None, None], U_b, U),
                torch.where(improved, cost_b, cost))

    U = torch.zeros((B, T, d), **kw) if u_init is None else u_init
    xs = _rollout(x0, U.transpose(0, 1), Phi, Bm)
    cost = total_cost(xs, U)
    trace = []
    for _ in range(params.opt_iters):
        xs, U, cost = iteration(xs, U, cost)
        trace.append(cost)
    cost_trace = (torch.stack(trace) if trace
                  else torch.zeros((0, B), **kw))
    return ILQRResult(trajs=xs, controls=U, costs=cost,
                      cost_trace=cost_trace)


def ilqr_solve(residual_fn: Callable, start_state, goal_state,
               params: ILQRParams, u_init=None, x_ref=None,
               q_limits=None) -> ILQRResult:
    """Batched iLQR solve.

    residual_fn: per-waypoint hinge obstacle residuals (e.g.
    ``PlanningTask.collision_residuals``); with ``supports_batch`` (and a
    batched ``residuals_and_jacobian``) every evaluation is one call over
    the whole flattened waypoint batch.  start_state / goal_state
    (..., 2d).  u_init (optional): warm-start controls (..., H-1, d),
    default a zero-control rollout.  x_ref (optional): (..., H, 2d)
    reference trajectory for the running and terminal goal costs
    (tracking MPC).  q_limits (optional): (q_min (d,), q_max (d,)) shared
    over the batch; activates the ``sigma_limits`` hinge.  Runs at full
    float32 matmul precision (TF32 off), like the GN solver.  Returns
    dynamically feasible trajectories.
    """
    disable_tf32()
    m = start_state.shape[-1]
    batch = start_state.shape[:-1]
    flat_u = (None if u_init is None
              else u_init.reshape((-1,) + u_init.shape[-2:]))
    flat_r = (None if x_ref is None
              else x_ref.reshape((-1,) + x_ref.shape[-2:]))
    res = _ilqr_batch(residual_fn, start_state.reshape(-1, m),
                      goal_state.reshape(-1, m), params, u_init=flat_u,
                      x_ref=flat_r, q_limits=q_limits)
    if batch:
        return ILQRResult(
            trajs=res.trajs.reshape(batch + res.trajs.shape[1:]),
            controls=res.controls.reshape(batch + res.controls.shape[1:]),
            costs=res.costs.reshape(batch),
            cost_trace=res.cost_trace.reshape((params.opt_iters,) + batch))
    return ILQRResult(trajs=res.trajs[0], controls=res.controls[0],
                      costs=res.costs[0], cost_trace=res.cost_trace[:, 0])
