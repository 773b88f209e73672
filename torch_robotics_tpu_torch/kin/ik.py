"""Batched inverse kinematics (counterpart of torch_robotics_tpu/kin/ik.py):
Adam on the SE(3) loss (``inverse_kinematics``, the reference's solver)
and damped least squares in the lane layout (``inverse_kinematics_gn``).

Both run a fixed number of iterations over the whole batch, keep the first
q of each problem that passes the validity test (``ik_valid_mask``), and
every ``restart_every`` iterations redraw the problems not yet valid
uniformly inside the limits.  The internal runs (``_ik_run``,
``_ik_gn_run``) take their restart draws as an object ``u`` whose ``u[i]``
is iteration i's uniforms (B, n_dofs), read only at restart iterations, so
a test can feed the reference's own draws; the public entry points draw
them, and the starts, from a ``torch.Generator``.

Adam is optax's, written out on plain tensors: moments mu and nu, one
scalar step count (bias correction by the count, eps 1e-8 inside no
root), and a restart zeroes mu and nu of the redrawn problems only; the
count runs on.  The gradient is autograd of the summed loss through the
lane FK chain.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.device import resolve_device
from ..core.se3 import SE3_distance
from .fk import fk_all_links
from .model import JOINT_PRISMATIC, KinematicModel

__all__ = ["IKResult", "ik_loss_per_q", "ik_valid_mask", "inverse_kinematics",
           "inverse_kinematics_gn"]

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


class IKResult(NamedTuple):
    q: torch.Tensor              # (B, n_dofs) final joint values
    valid: torch.Tensor          # (B,) bool: within limits and SE3 error < eps
    err_se3: torch.Tensor        # (B,) final SE(3) distances
    iters_to_valid: torch.Tensor  # (B,) first iteration valid (or max_iters)


def _limits(model: KinematicModel, lower, upper, ref: torch.Tensor):
    lower = model.q_lower if lower is None else lower
    upper = model.q_upper if upper is None else upper
    return (torch.as_tensor(lower, dtype=ref.dtype, device=ref.device),
            torch.as_tensor(upper, dtype=ref.dtype, device=ref.device))


def ik_loss_per_q(model: KinematicModel, q, H_target, link_name: str,
                  w_se3=1.0, w_joint_limits=300.0, lower=None, upper=None,
                  w_q_rest=1.0, q_rest=None):
    """Per-sample IK loss: w_se3 SE3_distance + a quadratic penalty past
    the joint limits [+ w_q_rest |q - q_rest|]: q (B, d) -> (B,)."""
    lower, upper = _limits(model, lower, upper, q)
    H = fk_all_links(model, q, link_list=[link_name])[..., 0, :, :]
    err_se3 = SE3_distance(H, H_target, w_pos=1.0, w_rot=1.0)
    err_lo = torch.sum(torch.square(lower - q) * (q < lower), dim=-1)
    err_hi = torch.sum(torch.square(upper - q) * (q > upper), dim=-1)
    err = w_se3 * err_se3 + w_joint_limits * (err_lo + err_hi)
    if q_rest is not None:
        err = err + w_q_rest * torch.linalg.vector_norm(q - q_rest, dim=-1)
    return err


def ik_valid_mask(model: KinematicModel, q, H_target, link_name: str,
                  lower=None, upper=None, se3_eps=1e-1):
    """(valid (B,): inside [lower, upper] and SE3_distance < se3_eps, the
    SE3_distance (B,))."""
    lower, upper = _limits(model, lower, upper, q)
    in_limits = torch.all((q >= lower) & (q <= upper), dim=-1)
    H = fk_all_links(model, q, link_list=[link_name])[..., 0, :, :]
    err = SE3_distance(H, H_target, w_pos=1.0, w_rot=1.0)
    return in_limits & (err < se3_eps), err


def _finish(model, H_target, link_name, q, lower, upper, se3_eps, valid,
            q_best, iters):
    """The first valid q of each problem valid at some iteration but not
    at the end, else the last iterate -> IKResult."""
    final_valid, _ = ik_valid_mask(model, q, H_target, link_name,
                                   lower=lower, upper=upper, se3_eps=se3_eps)
    q_out = torch.where((valid & ~final_valid)[:, None], q_best, q)
    _, err = ik_valid_mask(model, q_out, H_target, link_name, lower=lower,
                           upper=upper, se3_eps=se3_eps)
    return IKResult(q=q_out, valid=valid | final_valid, err_se3=err,
                    iters_to_valid=iters)


def _track(new_valid, q, i, valid, q_best, iters):
    """Record the problems valid for the first time at iteration i (q
    their iterate) -> (valid, q_best, iters_to_valid)."""
    first = new_valid & ~valid
    q_best = torch.where(first[:, None], q, q_best)
    iters = torch.where(first, torch.full_like(iters, i), iters)
    return valid | new_valid, q_best, iters


def _ik_run(model, H_target, link_name, q0, lower, upper, max_iters, lr,
            se3_eps, q_rest, u, restart_every: int = 50) -> IKResult:
    """Adam with solution freezing and resample-on-stall (module doc):
    H_target (1 or B, 4, 4), q0 (B, d), lower / upper (d,), u[i] (B, d)
    iteration i's restart uniforms."""
    q = q0
    mu, nu = torch.zeros_like(q0), torch.zeros_like(q0)
    count = 0
    valid = torch.zeros(q0.shape[0], dtype=torch.bool, device=q0.device)
    iters = torch.full((q0.shape[0],), max_iters, dtype=torch.int32,
                       device=q0.device)
    q_best = q0
    b1 = torch.tensor(_ADAM_B1, dtype=q0.dtype, device=q0.device)
    b2 = torch.tensor(_ADAM_B2, dtype=q0.dtype, device=q0.device)
    for i in range(max_iters):
        new_valid, _ = ik_valid_mask(model, q, H_target, link_name,
                                     lower=lower, upper=upper,
                                     se3_eps=se3_eps)
        valid, q_best, iters = _track(new_valid, q, i, valid, q_best, iters)
        if i % restart_every == restart_every - 1:
            mask = (~valid)[:, None]
            u_i = u[i].to(q.device, q.dtype)
            q = torch.where(mask, lower + u_i * (upper - lower), q)
            mu = torch.where(mask, torch.zeros_like(mu), mu)
            nu = torch.where(mask, torch.zeros_like(nu), nu)
        q_var = q.detach().requires_grad_(True)
        loss = torch.sum(ik_loss_per_q(model, q_var, H_target, link_name,
                                       lower=lower, upper=upper,
                                       q_rest=q_rest))
        g, = torch.autograd.grad(loss, q_var)
        mu = (1.0 - _ADAM_B1) * g + _ADAM_B1 * mu
        nu = (1.0 - _ADAM_B2) * torch.square(g) + _ADAM_B2 * nu
        count += 1
        mu_hat = mu / (1.0 - b1 ** count)
        nu_hat = nu / (1.0 - b2 ** count)
        q = q + -lr * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))
    return _finish(model, H_target, link_name, q, lower, upper, se3_eps,
                   valid, q_best, iters)


def _dls_setup(model: KinematicModel, H_target, link_name: str, ref):
    """The constants of a DLS run: (ee link, controlled links, ancestry of
    the EE link, prismatic flags, joint axes, R* and t* entries as lane
    scalars (shape (1,) or (B,)))."""
    Ht = H_target.to(ref.device, ref.dtype)
    ee = model.link_index(link_name)
    ctrl = list(model.controlled_link_idxs())
    return dict(
        ee=ee, ctrl=ctrl, anc=model.ancestry_matrix()[ee],
        prism=[model.joint_types[li] == JOINT_PRISMATIC for li in ctrl],
        axes=torch.as_tensor(model.joint_axis, dtype=ref.dtype,
                             device=ref.device),
        Rt=[[Ht[..., i, j] for j in range(3)] for i in range(3)],
        tt=[Ht[..., i, 3] for i in range(3)])


def _dls_step(model: KinematicModel, c, q, lower, upper, damping):
    """One damped-least-squares step in the lane layout, c from
    ``_dls_setup``: dq = J^T (J J^T + damping I)^-1 e, e the twist error
    (t* - t, log_SO3(R* R^T)), J the geometric Jacobian -> clip(q + dq,
    lower, upper)."""
    from ..ops.lanes_fk import _matvec3, fk_lanes
    from ..solve.btridiag_lanes import (_chol_lanes, _trsv_lower_lanes,
                                        _trsv_upper_lanes)
    Rt, tt, d = c["Rt"], c["tt"], model.n_dofs
    R_w, t_w = fk_lanes(model, q.T)
    R, t = R_w[c["ee"]], t_w[c["ee"]]
    R_err = [[sum(Rt[i][k] * R[j][k] for k in range(3))
              for j in range(3)] for i in range(3)]
    trR = torch.clamp((R_err[0][0] + R_err[1][1] + R_err[2][2] - 1.0)
                      * 0.5, -1.0, 1.0)
    theta = torch.arccos(trR)
    scale = theta / (2.0 * torch.sin(theta) + 1.0e-14)
    e = [tt[0] - t[0], tt[1] - t[1], tt[2] - t[2],
         scale * (R_err[2][1] - R_err[1][2]),
         scale * (R_err[0][2] - R_err[2][0]),
         scale * (R_err[1][0] - R_err[0][1])]
    e = [ek.expand(q.shape[:1]) for ek in e]

    # geometric Jacobian columns (6 rows x d columns of (B,) lanes)
    J = [[None] * d for _ in range(6)]
    for j, li in enumerate(c["ctrl"]):
        if not c["anc"][j]:
            continue
        z = _matvec3(R_w[li], c["axes"][li])
        if c["prism"][j]:
            for r in range(3):
                J[r][j] = z[r]
        else:
            dx = [t[k] - t_w[li][k] for k in range(3)]
            J[0][j] = z[1] * dx[2] - z[2] * dx[1]
            J[1][j] = z[2] * dx[0] - z[0] * dx[2]
            J[2][j] = z[0] * dx[1] - z[1] * dx[0]
            for r in range(3):
                J[3 + r][j] = z[r]

    # damped least squares: dq = J^T (J J^T + lam I)^-1 e, all lanes
    zero = torch.zeros_like(e[0])
    JJt = torch.stack([
        torch.stack([
            sum((J[a][k] * J[b][k] for k in range(d)
                 if J[a][k] is not None and J[b][k] is not None),
                start=zero) + (damping if a == b else 0.0)
            for b in range(6)])
        for a in range(6)])                                  # (6, 6, B)
    L = _chol_lanes(JJt)
    y = _trsv_upper_lanes(L, _trsv_lower_lanes(L, torch.stack(e)))
    dq = torch.stack([
        sum((J[a][k] * y[a] for a in range(6) if J[a][k] is not None),
            start=zero)
        for k in range(d)])                                  # (d, B)
    return torch.clamp(q + dq.T, lower, upper)


def _ik_gn_run(model, H_target, link_name, q0, lower, upper, max_iters,
               damping, se3_eps, u, restart_every) -> IKResult:
    """Damped least squares (``_dls_step``) with every per-iteration FK,
    Jacobian and 6x6 solve in the lane layout, the validity test on the
    lane FK too.  Arguments as ``_ik_run``."""
    from ..ops.lanes_fk import fk_lanes
    c = _dls_setup(model, H_target, link_name, q0)
    Rt, tt = c["Rt"], c["tt"]

    def se3_err(q):
        # SE3_distance: (1 - cos angle(R Rt^T)) + |t - tt|
        R_w, t_w = fk_lanes(model, q.T)
        R, t = R_w[c["ee"]], t_w[c["ee"]]
        tr = sum(R[i][j] * Rt[i][j] for i in range(3) for j in range(3))
        d2 = sum(torch.square(t[k] - tt[k]) for k in range(3))
        return (1.0 - (tr - 1.0) * 0.5) + torch.sqrt(d2)

    q = q0
    valid = torch.zeros(q0.shape[0], dtype=torch.bool, device=q0.device)
    iters = torch.full((q0.shape[0],), max_iters, dtype=torch.int32,
                       device=q0.device)
    q_best = q0
    for i in range(max_iters):
        in_limits = torch.all((q >= lower) & (q <= upper), dim=-1)
        valid, q_best, iters = _track(in_limits & (se3_err(q) < se3_eps), q,
                                      i, valid, q_best, iters)
        if i % restart_every == restart_every - 1:
            u_i = u[i].to(q.device, q.dtype)
            q = torch.where((~valid)[:, None], lower + u_i * (upper - lower),
                            q)
        q = _dls_step(model, c, q, lower, upper, damping)
    return _finish(model, H_target, link_name, q, lower, upper, se3_eps,
                   valid, q_best, iters)


class _RestartDraws:
    """``u[i]``: fresh uniforms (B, d) from ``generator`` on its own
    device, moved to ``device``; drawn when read (restart iterations
    only)."""

    def __init__(self, generator, shape, dtype, device):
        self.generator, self.shape = generator, shape
        self.dtype, self.device = dtype, device

    def __getitem__(self, i):
        return torch.rand(self.shape, generator=self.generator,
                          dtype=self.dtype,
                          device=self.generator.device).to(self.device)


def _setup(model, H_target, eps_joint_lim, generator, device):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    H_target = torch.as_tensor(H_target, dtype=torch.float32, device=dev)
    if H_target.dim() == 2:
        H_target = H_target[None]
    lower = torch.as_tensor(model.q_lower + eps_joint_lim, device=dev)
    upper = torch.as_tensor(model.q_upper - eps_joint_lim, device=dev)
    return dev, generator, H_target, lower, upper


def inverse_kinematics(
        model: KinematicModel, H_target, link_name: str = "ee_link",
        batch_size: int = 1, max_iters: int = 1000, lr: float = 1e-2,
        se3_eps: float = 1e-1, q0: Optional[torch.Tensor] = None,
        q0_noise: float = math.pi / 8, eps_joint_lim: float = math.pi / 100,
        q_rest: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda") -> IKResult:
    """Batched IK with Adam: H_target (4, 4) or (B, 4, 4).  The starts are
    uniform inside the joint limits shrunk by ``eps_joint_lim``, or a
    provided ``q0`` jittered by normals of ``q0_noise`` and clipped to
    them; starts and restart draws come from ``generator`` (None: a
    generator on ``device`` seeded 0)."""
    dev, generator, H_target, lower, upper = _setup(
        model, H_target, eps_joint_lim, generator, device)
    shape = (batch_size, model.n_dofs)
    if q0 is None:
        u = torch.rand(shape, generator=generator, device=generator.device)
        q0 = lower + u.to(dev) * (upper - lower)
    else:
        noise = torch.randn(shape, generator=generator,
                            device=generator.device).to(dev) * q0_noise
        q0 = torch.clamp(torch.as_tensor(q0, dtype=torch.float32,
                                         device=dev) + noise, lower, upper)
    if q_rest is not None:
        q_rest = torch.as_tensor(q_rest, dtype=torch.float32, device=dev)
    return _ik_run(model, H_target, link_name, q0, lower, upper, max_iters,
                   lr, se3_eps, q_rest,
                   _RestartDraws(generator, shape, torch.float32, dev))


def inverse_kinematics_gn(
        model: KinematicModel, H_target, link_name: str = "ee_link",
        batch_size: int = 1, max_iters: int = 60, damping: float = 1e-4,
        se3_eps: float = 1e-1, eps_joint_lim: float = math.pi / 100,
        restart_every: int = 20,
        generator: Optional[torch.Generator] = None,
        device="cuda") -> IKResult:
    """Damped-least-squares batched IK (the reference's beyond-source
    solver): dq = J^T (J J^T + damping I)^-1 e with the iterate clipped to
    the shrunk limits, unconverged problems redrawn every
    ``restart_every`` iterations; starts and draws from ``generator`` as
    ``inverse_kinematics``."""
    dev, generator, H_target, lower, upper = _setup(
        model, H_target, eps_joint_lim, generator, device)
    shape = (batch_size, model.n_dofs)
    u = torch.rand(shape, generator=generator, device=generator.device)
    q0 = lower + u.to(dev) * (upper - lower)
    return _ik_gn_run(model, H_target, link_name, q0, lower, upper,
                      max_iters, damping, se3_eps,
                      _RestartDraws(generator, shape, torch.float32, dev),
                      restart_every)
