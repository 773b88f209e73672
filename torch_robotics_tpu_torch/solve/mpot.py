"""MPOT: batched trajectory optimization by Sinkhorn steps (counterpart of
torch_robotics_tpu/solve/mpot.py; "Accelerating Motion Planning via
Optimal Transport", Le et al., NeurIPS 2023).

Each iteration (a Sinkhorn step):

1. the polytope direction set D (cube vertices, or +-e_i) is rotated by
   that iteration's random rotation Q;
2. every interior waypoint probes the cost at ``num_probe`` points along
   each direction out to ``probe_radius`` (the cost at the point and at
   its two segment midpoints, the neighbours fixed);
3. an entropic OT plan between the waypoints and the directions (uniform
   marginals) is solved by ``num_sinkhorn_iters`` Sinkhorn iterations at
   ``reg``, over the whole ensemble (``coupling`` 'full') or per
   trajectory;
4. the waypoints move by the barycentric displacement step_radius (P/a) D,
   both radii annealed by 1 / (1 + eps_annealing it).

Then ``smooth_iters`` clearance steps (unit gradient descent on the hinge
cost, ``torch.autograd.grad``) and as many collision-guarded Laplacian
smoothing steps; the velocities are the central differences of the
positions.  The endpoints stay pinned.  Every loop is a Python loop over
tensors on theta0's device; no kernel of its own runs here (the JAX
package's Sinkhorn step is plain XLA too).

The reference draws iteration ``it``'s rotation from ``fold_in(key, it)``;
the port draws the (opt_iters, d, d) stack from a ``torch.Generator``
(``mpot_rotations``) and ``_mpot_solve_core`` takes a given stack, so the
tests feed both packages the JAX package's own rotations.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["MPOTParams", "MPOTResult", "mpot_rotations", "mpot_solve",
           "polytope_vertices"]


@dataclasses.dataclass(frozen=True)
class MPOTParams:
    n_support_points: int = 64
    dt: float = 0.04
    opt_iters: int = 100
    reg: float = 0.01               # entropic regularization
    num_probe: int = 5
    num_sinkhorn_iters: int = 5
    step_radius: float = 0.038
    probe_radius: float = 0.05
    polytope: str = "cube"          # 'cube' | 'orthoplex'
    eps_annealing: float = 0.02
    # the clearance and guarded smoothing passes (each smooth_iters steps;
    # none where w_smooth <= 0)
    smooth_iters: int = 50
    smooth_alpha: float = 0.3
    w_smooth: float = 1e-7
    w_coll: float = 1.7e-3
    sigma_gp: float = 0.08
    sigma_start: float = 1e-4
    sigma_goal: float = 1e-4
    # 'full': one OT problem over every waypoint of the ensemble;
    # 'trajectory': one per trajectory (H x V)
    coupling: str = "full"

    @classmethod
    def from_preset(cls, preset: dict) -> "MPOTParams":
        """Build from a reference-style planner-params dict
        (``EnvBase.get_mpot_params``)."""
        solver = preset.get("solver_params", {}) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in preset.items() if k in known}
        if "reg" in solver:
            kwargs["reg"] = solver["reg"]
        if "numInnerItermax" in solver:
            kwargs["num_sinkhorn_iters"] = int(solver["numInnerItermax"])
        kwargs = {k: (int(v) if k in ("n_support_points", "opt_iters",
                                      "num_probe") else v)
                  for k, v in kwargs.items()}
        return cls(**kwargs)


class MPOTResult(NamedTuple):
    trajs: torch.Tensor          # (..., H, 2d)
    cost_trace: torch.Tensor     # (opt_iters, ...) probe-cost of each step


def polytope_vertices(dim: int, kind: str = "cube") -> np.ndarray:
    """Unit direction set: cube vertices (2^dim, normalized) or orthoplex
    (+-e_i, 2 dim).  Cube falls back to orthoplex beyond 2^10 vertices."""
    if kind == "cube" and dim <= 10:
        verts = np.array(list(itertools.product([-1.0, 1.0], repeat=dim)))
        return verts / np.sqrt(dim)
    eye = np.eye(dim)
    return np.concatenate([eye, -eye], axis=0)


def _sinkhorn(C, reg: float, iters: int):
    """Entropic OT between uniform marginals: C (..., n, m) -> plan P.
    The cost is first normalized to [0, 1] per problem, so that ``reg``
    acts on relative costs."""
    n, m = C.shape[-2], C.shape[-1]
    lo = torch.amin(C, dim=(-2, -1), keepdim=True)
    hi = torch.amax(C, dim=(-2, -1), keepdim=True)
    C = (C - lo) / torch.clamp(hi - lo, min=1e-30)
    K = torch.exp(-(C - torch.amin(C, dim=-1, keepdim=True)) / reg)
    u = torch.ones_like(C[..., :, 0]) / n
    for _ in range(iters):
        v = (1.0 / m) / torch.clamp(
            torch.einsum("...nm,...n->...m", K, u), min=1e-30)
        u = (1.0 / n) / torch.clamp(
            torch.einsum("...nm,...m->...n", K, v), min=1e-30)
    v = (1.0 / m) / torch.clamp(torch.einsum("...nm,...n->...m", K, u),
                                min=1e-30)
    return u[..., :, None] * K * v[..., None, :]


def mpot_rotations(generator: torch.Generator, n_iters: int, d: int):
    """The (n_iters, d, d) stack of random rotations: the Q of the QR of
    standard normals drawn in float32 on the generator's device.  Callers
    cast it to their dtype, so runs in float32 and float64 from one seed
    share their rotations."""
    A = torch.randn((n_iters, d, d), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return torch.linalg.qr(A).Q


def mpot_solve(state_cost_fn: Callable, theta0, start_state, goal_state,
               params: MPOTParams,
               generator: Optional[torch.Generator] = None,
               hinge_cost_fn: Optional[Callable] = None) -> MPOTResult:
    """Optimize trajectories theta0 (..., H, 2d) with Sinkhorn steps.

    ``state_cost_fn`` maps states x (..., 2d) to a per-waypoint cost (...)
    (e.g. the task's 'sdf' cost of the position part); ``hinge_cost_fn``,
    a non-negative cost that is zero where a waypoint is clear (e.g. the
    clamped 'sdf' cost), guards the smoothing and drives the clearance
    step (default relu of ``state_cost_fn``).  ``generator`` (None: a CPU
    generator seeded 0) draws the rotations (``mpot_rotations``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    d = theta0.shape[-1] // 2
    rotations = mpot_rotations(generator, params.opt_iters, d)
    return _mpot_solve_core(state_cost_fn, theta0, start_state, goal_state,
                            params, rotations, hinge_cost_fn)


def _neighbors(X):
    """Each waypoint's previous and next waypoint (the ends their own)."""
    x_prev = torch.cat([X[..., :1, :], X[..., :-1, :]], dim=-2)
    x_next = torch.cat([X[..., 1:, :], X[..., -1:, :]], dim=-2)
    return x_prev, x_next


def _mpot_solve_core(state_cost_fn, theta0, start_state, goal_state,
                     params: MPOTParams, rotations,
                     hinge_cost_fn=None) -> MPOTResult:
    """``mpot_solve`` on given rotations (opt_iters, d, d)."""
    H = theta0.shape[-2]
    d = theta0.shape[-1] // 2
    kw = dict(dtype=theta0.dtype, device=theta0.device)
    X = theta0[..., :d]
    X = torch.cat([start_state[..., None, :d].expand(X[..., :1, :].shape),
                   X[..., 1:-1, :],
                   goal_state[..., None, :d].expand(X[..., -1:, :].shape)],
                  dim=-2)
    D = torch.as_tensor(polytope_vertices(d, params.polytope), **kw)
    Qs = rotations.to(**kw)
    # the reference probes collision only (its smoothness weight in the
    # probe cost is fixed at 0); the GP smoothness comes from the guarded
    # smoothing pass, whose length w_smooth switches on
    smooth_iters = params.smooth_iters if params.w_smooth > 0 else 0
    move_mask = torch.cat([torch.zeros((1, 1), **kw),
                           torch.ones((H - 2, 1), **kw),
                           torch.zeros((1, 1), **kw)])            # (H, 1)

    def at_rest(fn):
        """fn on positions (..., d) with zero velocities."""
        return lambda pts: fn(torch.cat([pts, torch.zeros_like(pts)], -1))

    raw_cost = at_rest(state_cost_fn)
    hinge_cost = (at_rest(hinge_cost_fn) if hinge_cost_fn is not None
                  else lambda pts: torch.relu(raw_cost(pts)))

    def with_midpoints(fn, cand, x_prev, x_next):
        """fn at a candidate waypoint plus half of fn at its two segment
        midpoints (neighbours fixed), the three in one call."""
        cand, x_prev, x_next = torch.broadcast_tensors(cand, x_prev, x_next)
        c = fn(torch.stack([cand, 0.5 * (cand + x_prev),
                            0.5 * (cand + x_next)]))
        return c[0] + 0.5 * c[1] + 0.5 * c[2]

    def traj_cost(X):
        x_prev, x_next = _neighbors(X)
        return params.w_coll * torch.sum(
            with_midpoints(raw_cost, X, x_prev, x_next), dim=-1)

    fracs = np.linspace(1.0 / params.num_probe, 1.0, params.num_probe)
    costs = []
    for it in range(params.opt_iters):
        anneal = 1.0 / (1.0 + params.eps_annealing
                        * torch.tensor(float(it), **kw))
        step_r = params.step_radius * anneal
        probe_r = params.probe_radius * anneal
        D_it = D @ Qs[it]                                         # (V, d)
        # every probe fraction in one call: (..., H, F, V) costs, summed
        # over F in the reference's order
        fr = torch.stack([probe_r * float(f) for f in fracs])     # (F,)
        cand = X[..., :, None, None, :] + fr[:, None, None] * D_it
        x_prev, x_next = _neighbors(X)
        probe = params.w_coll * with_midpoints(
            raw_cost, cand, x_prev[..., :, None, None, :],
            x_next[..., :, None, None, :])
        C = probe[..., 0, :]
        for k in range(1, len(fracs)):
            C = C + probe[..., k, :]
        C = C / params.num_probe                                  # (..., H, V)
        if params.coupling == "full":
            n_pts = C[..., 0].numel()
            P = _sinkhorn(C.reshape(n_pts, C.shape[-1]), params.reg,
                          params.num_sinkhorn_iters).reshape(C.shape)
            scale = float(n_pts)
        else:
            P = _sinkhorn(C, params.reg, params.num_sinkhorn_iters)
            scale = float(H)
        disp = torch.einsum("...hv,vd->...hd", P * scale, D_it) * step_r
        X = X + move_mask * disp
        costs.append(traj_cost(X))

    def total_hinge(Xh):
        x_prev, x_next = _neighbors(Xh)
        return torch.sum(with_midpoints(hinge_cost, Xh, x_prev, x_next))

    # clearance: unit steps down the hinge cost's gradient push in-margin
    # waypoints out, and are exactly zero elsewhere
    for _ in range(smooth_iters):
        with torch.enable_grad():
            Xg = X.detach().requires_grad_(True)
            g, = torch.autograd.grad(total_hinge(Xg), Xg)
        g_norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        unit = g / torch.clamp(g_norm, min=1e-12)
        X = X - 0.01 * move_mask * unit * (g_norm > 0)

    # guarded Laplacian smoothing: a waypoint moves toward its neighbours'
    # midpoint only where the move keeps its guard cost at zero or lowers
    # it, so smoothing never undoes the clearance
    for _ in range(smooth_iters):
        x_prev, x_next = _neighbors(X)
        mid = 0.5 * (x_prev + x_next)
        cand = X + params.smooth_alpha * move_mask * (mid - X)
        c = with_midpoints(hinge_cost, torch.stack([X, cand]),
                           torch.stack([x_prev, x_prev]),
                           torch.stack([x_next, x_next]))
        c_old, c_new = c[0], c[1]
        ok = (c_new <= 0.0) | (c_new <= c_old)
        X = torch.where(ok[..., None], cand, X)

    v_mid = (X[..., 2:, :] - X[..., :-2, :]) / (2.0 * params.dt)
    v = torch.cat([start_state[..., None, d:].expand(X[..., :1, :].shape),
                   v_mid,
                   goal_state[..., None, d:].expand(X[..., -1:, :].shape)],
                  dim=-2)
    return MPOTResult(trajs=torch.cat([X, v], dim=-1),
                      cost_trace=torch.stack(costs))
