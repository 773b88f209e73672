"""Task-space (end-effector SE(3)) goal factor for the Gauss-Newton
solvers (counterpart of torch_robotics_tpu/solve/ee_goal.py).

The final waypoint carries residuals on the EE pose instead of a
configuration-space goal:

    r_pos = w_pos (p_ee(q) - p*)          (3 residuals)
    r_rot = w_rot vec(R_ee(q) - R*)       (9 residuals, column by column)

with analytic Jacobians (dp/dq_j = z_j x (p - t_j), z_j for a prismatic
joint; dR_col/dq_j = z_j x R_col for a revolute one), masked by the
joint's ancestry of the EE link and by q inside the joint's clamps.  The
FK is the lane chain (``ops/lanes_fk.fk_lanes`` on q^T), as the port's
other terms are; the reference runs the same formulas on its
array-of-structures chain.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.device import resolve_device
from ..kin.model import JOINT_PRISMATIC, KinematicModel

__all__ = ["make_ee_goal_terms"]


def _cross(a, b):
    """Cross product of two (3, N) lane vectors -> (3, N)."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def make_ee_goal_terms(robot, target_H, w_pos: float = 1.0,
                       w_rot: float = 1.0, sigma_ee: float = 1e-2,
                       device="cuda") -> Callable:
    """The GN terms of an EE-pose goal on the final waypoint.

    robot: a kinematic robot (``model``, ``link_name_ee``); target_H: (4, 4)
    target pose, held on ``device``.  Returns terms(q (..., d)) -> (g (...,
    m), Hb (..., m, m), err (...)), m = 2 d: the factor's gradient and
    Gauss-Newton Hessian (lam = 1 / sigma_ee^2) on the position part of
    the state, and the weighted residual's norm."""
    from ..ops.lanes_fk import _matvec3, fk_lanes
    model: KinematicModel = robot.model
    ee = model.link_index(robot.link_name_ee)
    target = torch.as_tensor(target_H, dtype=torch.float32,
                             device=resolve_device(device))
    lam = 1.0 / (sigma_ee ** 2)
    ctrl = list(model.controlled_link_idxs())
    anc = model.ancestry_matrix()[ee]

    def terms(q):
        batch, d = q.shape[:-1], q.shape[-1]
        m = 2 * d
        q_cols = q.reshape(-1, d).T                            # (d, N)
        N = q_cols.shape[1]
        tgt = target.to(q.device, q.dtype)
        axes = model.tensors["joint_axis"].to(q.device, q.dtype)
        R_w, t_w = fk_lanes(model, q_cols)
        p, R = t_w[ee], R_w[ee]                                # (3, N), (3, 3, N)

        zero = q_cols.new_zeros((12, N))
        cols = []
        for j, li in enumerate(ctrl):
            if not anc[j]:
                cols.append(zero)
                continue
            z = _matvec3(R_w[li], axes[li])                    # (3, N)
            in_lim = ((q_cols[j] >= float(model.clamp_lower[li]))
                      & (q_cols[j] <= float(model.clamp_upper[li])))
            if model.joint_types[li] == JOINT_PRISMATIC:
                col = torch.cat([w_pos * z, zero[:9]])
            else:
                # rotation rows k * 3 + i: (z x R[:, k])_i
                col = torch.cat([w_pos * _cross(z, p - t_w[li])]
                                + [w_rot * _cross(z, R[:, k])
                                   for k in range(3)])
            cols.append(col * in_lim.to(q.dtype))
        J = torch.stack(cols, dim=1)                           # (12, d, N)
        r = torch.cat([w_pos * (p - tgt[:3, 3, None]),
                       w_rot * (R - tgt[:3, :3, None]).transpose(0, 1)
                       .reshape(9, N)])                        # (12, N)

        g = q.new_zeros((N, m))
        g[:, :d] = lam * torch.sum(J * r[:, None, :], dim=0).T
        Hb = q.new_zeros((N, m, m))
        Hb[:, :d, :d] = lam * torch.sum(
            J[:, :, None, :] * J[:, None, :, :], dim=0).permute(2, 0, 1)
        err = torch.linalg.vector_norm(r, dim=0)
        return (g.reshape(batch + (m,)), Hb.reshape(batch + (m, m)),
                err.reshape(batch))

    return terms
