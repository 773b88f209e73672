"""Trajectory interpolation and spline smoothing (counterpart of
torch_robotics_tpu/trajectory/utils.py: the waypoint interpolation that
the collision metrics use, and the clamped cubic spline that the hybrid
planner resamples its RRT path with)."""
from __future__ import annotations

import torch

__all__ = ["interpolate_traj_via_points", "smoothen_trajectory"]


def interpolate_traj_via_points(trajs: torch.Tensor,
                                num_interpolation: int = 10):
    """Linear interpolation between consecutive waypoints: for each of the
    H-1 segments, ``num_interpolation`` points at alpha in
    linspace(0, 1, n + 2)[1:n + 1] mixing waypoint_t * alpha +
    waypoint_{t+1} * (1 - alpha).  trajs (..., H, D) ->
    (..., (H - 1) n, D)."""
    H, D = trajs.shape[-2:]
    if num_interpolation <= 0:
        return trajs
    alpha = torch.linspace(0.0, 1.0, num_interpolation + 2,
                           dtype=trajs.dtype, device=trajs.device)
    alpha = alpha[1:num_interpolation + 1].reshape(
        (1,) * (trajs.dim() - 1) + (-1, 1))
    left = trajs[..., :H - 1, None, :]
    right = trajs[..., 1:H, None, :]
    out = left * alpha + right * (1.0 - alpha)
    return out.reshape(trajs.shape[:-2] + ((H - 1) * num_interpolation, D))


def _clamped_cubic_spline(y: torch.Tensor, t_eval: torch.Tensor):
    """Evaluate a clamped (zero end-slope) cubic spline through y at t_eval.

    y: (N, D) knots at t = linspace(0, 1, N); t_eval: (M,) in [0, 1] ->
    (pos (M, D), vel (M, D)).  The second derivatives m solve the clamped
    tridiagonal system

        h/3 m_0 + h/6 m_1                     = dy_0
        h/6 m_{i-1} + 2h/3 m_i + h/6 m_{i+1}  = dy_i - dy_{i-1}
        h/6 m_{N-2} + h/3 m_{N-1}             = -dy_{N-2}

    by the Thomas sweep, a Python loop over the N knots on (D,) tensors (the
    reference's fori_loop, column by column)."""
    N = y.shape[0]
    h = 1.0 / (N - 1)
    kw = dict(dtype=y.dtype, device=y.device)
    diag = torch.cat([torch.tensor([h / 3.0], **kw),
                      torch.full((N - 2,), 2.0 * h / 3.0, **kw),
                      torch.tensor([h / 3.0], **kw)])
    off = torch.full((N - 1,), h / 6.0, **kw)
    dy = (y[1:] - y[:-1]) / h
    rhs = torch.cat([dy[:1], dy[1:] - dy[:-1], -dy[-1:]], dim=0)

    c_p = [off[0] / diag[0]]
    d_p = [rhs[0] / diag[0]]
    for i in range(1, N):
        denom = diag[i] - off[i - 1] * c_p[i - 1]
        c_p.append(off[min(i, N - 2)] / denom if i < N - 1
                   else torch.zeros((), **kw))
        d_p.append((rhs[i] - off[i - 1] * d_p[i - 1]) / denom)
    m = [None] * N
    m[N - 1] = d_p[N - 1]
    for j in range(N - 2, -1, -1):
        m[j] = d_p[j] - c_p[j] * m[j + 1]
    m = torch.stack(m)                                    # (N, D)

    t_eval = torch.clamp(t_eval, 0.0, 1.0)
    seg = torch.clamp((t_eval / h).to(torch.int32), 0, N - 2).long()
    t0 = seg.to(y.dtype) * h
    u = (t_eval - t0)[:, None]
    y0, y1 = y[seg], y[seg + 1]
    m0, m1 = m[seg], m[seg + 1]
    a = (m1 - m0) / (6.0 * h)
    b = m0 / 2.0
    c = (y1 - y0) / h - h * (2.0 * m0 + m1) / 6.0
    pos = y0 + u * (c + u * (b + u * a))
    vel = c + u * (2.0 * b + 3.0 * u * a)
    return pos, vel


def smoothen_trajectory(traj_pos: torch.Tensor, n_support_points: int = 30,
                        dt: float = 0.02, set_average_velocity: bool = True,
                        zero_velocity: bool = False):
    """Resample a coarse path onto ``n_support_points`` with the clamped
    cubic spline: traj_pos (N, D) -> (pos (n, D), vel (n, D)), the
    velocities zero, the reference's "average" ((traj_pos[1] - traj_pos[0])
    / (n dt) on the interior points, zero at the ends) or the spline's."""
    assert not (set_average_velocity and zero_velocity)
    if traj_pos.shape[0] < 2:
        traj_pos = torch.cat([traj_pos, traj_pos[-1:]], dim=0)
    t_eval = torch.linspace(0.0, 1.0, n_support_points, dtype=traj_pos.dtype,
                            device=traj_pos.device)
    pos, vel_spline = _clamped_cubic_spline(traj_pos, t_eval)
    vel = torch.zeros_like(pos)
    if zero_velocity:
        pass
    elif set_average_velocity:
        vel[1:-1] = (traj_pos[1] - traj_pos[0]) / (n_support_points * dt)
    else:
        vel = vel_spline
    return pos, vel
