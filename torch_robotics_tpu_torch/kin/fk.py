"""Batched forward kinematics and Jacobians on a compiled KinematicModel
(counterpart of torch_robotics_tpu/kin/fk.py).

Two chains compute the same poses.  The lane chain (``ops/lanes_fk.py``:
the batch in the last axis, the per-link constants Python scalars) carries
``fk_all_links`` and ``fk_link_positions``.  The array-of-structures chain
``fk_rot_trans`` (q (..., d) -> R (..., L, 3, 3), t (..., L, 3)) carries
the geometric and point Jacobians, the velocity propagation and the
forward-mode ``analytical_jacobian``, which ``torch.func`` transforms per
sample.  Its 3x3 products are elementwise multiply-reduces: full float32
on every device, no library GEMM.

Semantics follow the reference: revolute and prismatic q are clamped to
their limits inside FK (continuous joints are not), and a Jacobian column of
a joint outside its clamps is zero where ``q`` is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.se3 import (axis_angle_rotation, link_pos_from_link_tensor,
                        link_quat_from_link_tensor, pack_homogeneous)
from .model import (JOINT_CONTINUOUS, JOINT_PRISMATIC, JOINT_REVOLUTE,
                    KinematicModel)

__all__ = ["local_joint_transforms", "fk_rot_trans", "fk_all_links",
           "fk_link_positions", "fk_with_velocities", "geometric_jacobian",
           "point_jacobians", "analytical_jacobian"]


def _mm(A, B):
    """(..., 3, 3) x (..., 3, 3) as a multiply-reduce."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _mv(A, v):
    """(..., 3, 3) x (..., 3) as a multiply-reduce."""
    return torch.sum(A * v[..., None, :], dim=-1)


def _masks(model: KinematicModel, dtype, device):
    """(rot_mask, prism_mask) (n_links,): 1 for a revolute or continuous /
    a prismatic joint."""
    types = np.asarray(model.joint_types)
    rot = np.isin(types, (JOINT_REVOLUTE, JOINT_CONTINUOUS))
    return (torch.as_tensor(rot, dtype=dtype, device=device),
            torch.as_tensor(types == JOINT_PRISMATIC, dtype=dtype,
                            device=device))


def _const(model: KinematicModel, name: str, ref: torch.Tensor):
    return torch.as_tensor(getattr(model, name), dtype=ref.dtype,
                           device=ref.device)


def local_joint_transforms(model: KinematicModel, q: torch.Tensor):
    """Per-link local (R, t) from joint values: q (..., n_dofs) -> R (...,
    n_links, 3, 3), t (..., n_links, 3)."""
    rot_mask, prism_mask = _masks(model, q.dtype, q.device)
    if model.n_dofs > 0:
        q_link = q[..., torch.as_tensor(model.q_map, device=q.device)]
    else:
        q_link = q.new_zeros(q.shape[:-1] + (model.n_links,))
    q_link = torch.clamp(q_link * (rot_mask + prism_mask),
                         _const(model, "clamp_lower", q),
                         _const(model, "clamp_upper", q))
    axis = _const(model, "joint_axis", q)
    R = _mm(_const(model, "joint_fixed_rot", q),
            axis_angle_rotation(axis, q_link * rot_mask))
    t = (_const(model, "joint_trans", q)
         + axis * (q_link * prism_mask)[..., None])
    return R, t


def fk_rot_trans(model: KinematicModel, q: torch.Tensor, base_rot=None,
                 base_trans=None):
    """World (R, t) of every link: q (..., n_dofs) -> R (..., n_links, 3,
    3), t (..., n_links, 3).  An optional base pose (base_rot (..., 3, 3),
    base_trans (..., 3), each independent) places the root link."""
    R_loc, t_loc = local_joint_transforms(model, q)
    R_w = [None] * model.n_links
    t_w = [None] * model.n_links
    for i in model.topological_order():
        p = model.parent_idx[i]
        Ri, ti = R_loc[..., i, :, :], t_loc[..., i, :]
        if p < 0:
            if base_rot is not None:
                Ri, ti = _mm(base_rot, Ri), _mv(base_rot, ti)
            if base_trans is not None:
                ti = ti + base_trans
            R_w[i], t_w[i] = Ri, ti
        else:
            R_w[i] = _mm(R_w[p], Ri)
            t_w[i] = _mv(R_w[p], ti) + t_w[p]
    R_w = torch.broadcast_tensors(*R_w)
    t_w = torch.broadcast_tensors(*t_w)
    return torch.stack(R_w, dim=-3), torch.stack(t_w, dim=-2)


def _base_lanes(pose, k: int, ref: torch.Tensor):
    """A base rotation (k = 2) or translation (k = 1) in the lane layout:
    (3, 3) / (3,) as is, batched (..., 3, 3) / (..., 3) flattened into
    the lane axis, (3, 3, N) / (3, N)."""
    pose = torch.as_tensor(pose, dtype=ref.dtype, device=ref.device)
    if pose.dim() == k:
        return pose
    flat = pose.reshape((-1,) + pose.shape[-k:])
    return flat.permute(tuple(range(1, k + 1)) + (0,))


def fk_all_links(model: KinematicModel, q: torch.Tensor,
                 link_list: Optional[Sequence[str]] = None,
                 base_rot=None, base_trans=None):
    """Link poses as homogeneous matrices: q (..., n_dofs) ->
    (..., n_links, 4, 4) in URDF file order; ``link_list`` selects and
    orders a subset of links.  An optional base pose (base_rot (3, 3) or
    (..., 3, 3), base_trans (3,) or (..., 3); batched poses flatten into
    the lanes and broadcast against q's batch) places the root."""
    from ..ops.lanes_fk import _matmul3, _matvec3, fk_lanes
    batch = q.shape[:-1]
    d = q.shape[-1]
    R_w, t_w = fk_lanes(model, q.reshape(-1, d).T)
    if base_rot is not None or base_trans is not None:
        Rb = (torch.eye(3, dtype=q.dtype, device=q.device)
              if base_rot is None else _base_lanes(base_rot, 2, q))
        tb = (torch.zeros(3, dtype=q.dtype, device=q.device)
              if base_trans is None else _base_lanes(base_trans, 1, q))
        if tb.dim() == 1:
            tb = tb[:, None]
        R_w = [_matmul3(Rb, R) for R in R_w]
        t_w = [_matvec3(Rb, t) + tb for t in t_w]
    links = (range(model.n_links) if link_list is None
             else [model.link_index(n) for n in link_list])
    R = torch.stack([R_w[li] for li in links])              # (L, 3, 3, N)
    t = torch.stack([t_w[li] for li in links])              # (L, 3, N)
    L, N = R.shape[0], R.shape[-1]
    H = torch.zeros((N, L, 4, 4), dtype=q.dtype, device=q.device)
    H[..., :3, :3] = R.permute(3, 0, 1, 2)
    H[..., :3, 3] = t.permute(2, 0, 1)
    H[..., 3, 3] = 1.0
    return H.reshape(batch + (L, 4, 4))


def fk_link_positions(model: KinematicModel, q: torch.Tensor,
                      link_idxs=None):
    """World positions of (a subset of) links through the lane chain:
    q (..., n_dofs) -> (..., L, 3)."""
    from ..ops.lanes_fk import fk_positions_lanes
    return fk_positions_lanes(model, q, link_idxs=link_idxs)


def fk_with_velocities(model: KinematicModel, q: torch.Tensor,
                       qd: torch.Tensor):
    """FK with body velocities in each link's own frame: the child's twist
    is the joint's (angular qd * axis for a revolute joint, linear for a
    prismatic one) plus the parent's moved into the child frame by the
    inverse joint pose.  q, qd (..., n_dofs) -> (R (..., L, 3, 3), t (...,
    L, 3), lin (..., L, 3), ang (..., L, 3))."""
    R_loc, t_loc = local_joint_transforms(model, q)
    rot_mask, prism_mask = _masks(model, q.dtype, q.device)
    if model.n_dofs > 0:
        qd_link = (qd[..., torch.as_tensor(model.q_map, device=q.device)]
                   * (rot_mask + prism_mask))
    else:
        qd_link = q.new_zeros(q.shape[:-1] + (model.n_links,))
    axis = _const(model, "joint_axis", q)
    ang_joint = axis * (qd_link * rot_mask)[..., None]
    lin_joint = axis * (qd_link * prism_mask)[..., None]

    n = model.n_links
    R_w, t_w, lin, ang = [None] * n, [None] * n, [None] * n, [None] * n
    for i in model.topological_order():
        p = model.parent_idx[i]
        Ri, ti = R_loc[..., i, :, :], t_loc[..., i, :]
        if p < 0:
            R_w[i], t_w[i] = Ri, ti
            lin[i] = torch.zeros_like(ti)
            ang[i] = torch.zeros_like(ti)
            continue
        R_w[i] = _mm(R_w[p], Ri)
        t_w[i] = _mv(R_w[p], ti) + t_w[p]
        R_inv = Ri.transpose(-1, -2)
        t_inv = -_mv(R_inv, ti)
        ang_p = _mv(R_inv, ang[p])
        lin_p = torch.linalg.cross(t_inv, ang_p) + _mv(R_inv, lin[p])
        ang[i] = ang_joint[..., i, :] + ang_p
        lin[i] = lin_joint[..., i, :] + lin_p
    return (torch.stack(R_w, dim=-3), torch.stack(t_w, dim=-2),
            torch.stack(lin, dim=-2), torch.stack(ang, dim=-2))


def _joint_axes(model: KinematicModel, R, ctrl):
    """World axes z_j (..., J, 3) of the controlled joints ``ctrl``."""
    return _mv(R[..., ctrl, :, :], _const(model, "joint_axis", R)[ctrl])


def geometric_jacobian(model: KinematicModel, q: torch.Tensor,
                       link_name: str):
    """Geometric Jacobian of one link frame: q (..., n_dofs) -> (lin_jac,
    ang_jac), each (..., 3, n_dofs).  Column j is z_j x (p - p_j) / z_j
    for a revolute ancestor j, z_j / 0 for a prismatic one, else 0."""
    R, t = fk_rot_trans(model, q)
    ee = model.link_index(link_name)
    ctrl = list(model.controlled_link_idxs())
    z = _joint_axes(model, R, ctrl)
    mask = torch.as_tensor(model.ancestry_matrix()[ee], dtype=q.dtype,
                           device=q.device)[:, None]
    prism = _masks(model, q.dtype, q.device)[1][ctrl][:, None]
    lin_rev = torch.linalg.cross(z, t[..., ee, None, :] - t[..., ctrl, :])
    lin = torch.where(prism > 0, z, lin_rev) * mask
    ang = z * (1.0 - prism) * mask
    return lin.transpose(-1, -2), ang.transpose(-1, -2)


def point_jacobians(model: KinematicModel, R, t, points, point_link_idx,
                    q=None):
    """Position Jacobians of points fixed to links: R, t from
    ``fk_rot_trans``, points (..., P, 3) in the world, point_link_idx (P,)
    their links -> J (..., P, 3, n_dofs); column j is z_j x (p - t_j) for a
    revolute ancestor j of the point's link, z_j for a prismatic one, else
    0, and 0 for a joint outside its clamps when ``q`` is given."""
    ctrl = list(model.controlled_link_idxs())
    z = _joint_axes(model, R, ctrl)                          # (..., J, 3)
    mask = torch.as_tensor(
        model.ancestry_matrix()[np.asarray(point_link_idx)],
        dtype=points.dtype, device=points.device)            # (P, J)
    prism = _masks(model, points.dtype, points.device)[1][ctrl]
    diff = points[..., :, None, :] - t[..., None, ctrl, :]   # (..., P, J, 3)
    lin_rev = torch.linalg.cross(z[..., None, :, :].expand_as(diff), diff)
    J = torch.where(prism[:, None] > 0, z[..., None, :, :], lin_rev)
    J = J * mask[..., None]
    if q is not None:
        in_limits = ((q >= _const(model, "clamp_lower", q)[ctrl])
                     & (q <= _const(model, "clamp_upper", q)[ctrl]))
        J = J * in_limits.to(J.dtype)[..., None, :, None]
    return J.transpose(-1, -2)                               # (..., P, 3, J)


def analytical_jacobian(model: KinematicModel, q: torch.Tensor,
                        link_list=None):
    """Jacobian of each link's stacked [position (3), wxyz quaternion (4)]
    by forward-mode AD through ``fk_rot_trans`` (``torch.func.jacfwd``,
    vmapped over the batch): q (n_dofs,) -> (n_links, 7, n_dofs), q (B,
    n_dofs) -> (B, n_links, 7, n_dofs)."""
    idx = (None if link_list is None
           else [model.link_index(n) for n in link_list])

    def f(q_single):
        R, t = fk_rot_trans(model, q_single)
        H = pack_homogeneous(R, t)
        if idx is not None:
            H = H[..., idx, :, :]
        return torch.cat([link_pos_from_link_tensor(H),
                          link_quat_from_link_tensor(H)], dim=-1)

    jac = torch.func.jacfwd(f)
    return jac(q) if q.dim() == 1 else torch.func.vmap(jac)(q)
