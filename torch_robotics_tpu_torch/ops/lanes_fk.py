"""Lane-layout FK and Gauss-Newton obstacle terms in plain PyTorch
(counterpart of torch_robotics_tpu/ops/lanes_fk.py).

Every per-waypoint quantity keeps the batch in the last (lane) axis: link
rotations are (3, 3, N), translations and points (3, N), point Jacobians
(P, d, 3, N).  Scene queries take points of the workspace's dimension
(``ws_dim`` = 2 or 3, read from the points' leading axis): 2-D points are
lifted with z = 0 into each object's frame, and gradients come back with
``ws_dim`` components.

A robot that holds a grasped object has, beside its link origins, points
fixed in the frame of its grasped link (``offset_points``: R p + t), in
its object rows and its self-collision pairs.

``obstacle_terms_lanes_factory`` is the plain version of the fused CUDA
terms kernel (``ops/terms_kernel.py``): the same residual rows, the same
analytic gradients, the same assembly, written as tensor ops.  It runs on
CPU tensors (the tests, the CPU path of the port) and is what the kernel
is held against on the card; for a point mass, which has no fused kernel
in either package, it is the terms on every device.
``obstacle_terms_lanes_multirobot_factory`` is, in the same way, the plain
version of the MultiRobot terms kernel: member-width Jacobians and a
block-by-block assembly.  A MultiRobot whose pair list holds a mutual pair
between two object points of one member takes the generic padded
assembly instead (``obstacle_terms_lanes_factory``'s MultiRobot branch,
every point's Jacobian padded to the full width and every row reduced over
every column), as the reference does.

The SDF gradient is analytic: for the primitive that attains the minimum,
the derivative of its closed-form distance, rotated back to the world
frame.  That is the gradient of the min the reference differentiates with
``jax.vjp``; the two differ only at exact ties between primitives, a
measure-zero set.  A precomputed grid (``geom/grid_sdf.GridSDF``) in the
scene gives its nearest cell's value and gradient (the reference's
surrogate gradient); grids and analytic objects combine in list order, a
later one taking the minimum only where it is strictly smaller.  These grid
lookups are the plain version of the CUDA kernels' in-kernel lookup
(``csrc/kin_scene.cuh::grid_sdf``).
"""
from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..geom.grid_sdf import GridSDF
from ..kin.model import (JOINT_CONTINUOUS, JOINT_PRISMATIC, JOINT_REVOLUTE,
                         KinematicModel)
from .net_kernel import net_rows

__all__ = ["fk_lanes", "fk_positions_lanes", "fk_points_jacobians_lanes",
           "point_jacobians_lanes", "offset_points", "member_collision_points",
           "group_sdf_and_grad_lanes", "sdf_and_grad_lanes", "sdf_lanes",
           "lanes_supported_scene",
           "obstacle_terms_lanes_factory", "embed_terms", "hinge_rows",
           "PointMassLayout",
           "MultiRobotLayout", "obstacle_terms_lanes_multirobot_factory"]


def _matmul3(A, B):
    """(3, 3[, N]) x (3, 3, N) -> (3, 3, N) as an elementwise
    multiply-reduce (full float32 on every device, no library GEMM)."""
    if A.dim() == 2:
        A = A[:, :, None]
    return torch.sum(A[:, :, None, :] * B[None, :, :, :], dim=1)


def _matvec3(A, v):
    """(3, 3[, N]) x (3[, N]) -> (3, N)."""
    if A.dim() == 2:
        A = A[:, :, None]
    if v.dim() == 1:
        v = v[:, None]
    return torch.sum(A * v[None, :, :], dim=1)


def fk_lanes(model: KinematicModel, q_cols: torch.Tensor):
    """FK with the batch in lanes: q_cols (d, N) -> (R_w, t_w), lists over
    links of (3, 3, N) world rotations and (3, N) world translations.

    Revolute and prismatic q are clamped to their limits first; continuous
    joints are not."""
    N = q_cols.shape[-1]
    q_map = model.q_map
    consts = model.tensors
    dev, dtype = q_cols.device, q_cols.dtype
    F_all = consts["joint_fixed_rot"].to(dev, dtype)
    trans_all = consts["joint_trans"].to(dev, dtype)

    R_w: List[torch.Tensor] = [None] * model.n_links
    t_w: List[torch.Tensor] = [None] * model.n_links
    for i in model.topological_order():
        jtype = model.joint_types[i]
        F = F_all[i]
        trans = trans_all[i][:, None].expand(3, N)
        if jtype in (JOINT_REVOLUTE, JOINT_CONTINUOUS):
            qi = q_cols[int(q_map[i])]
            if jtype == JOINT_REVOLUTE:
                qi = torch.clamp(qi, float(model.clamp_lower[i]),
                                 float(model.clamp_upper[i]))
            c, s = torch.cos(qi), torch.sin(qi)
            ax, ay, az = (float(v) for v in model.joint_axis[i])
            one_c = 1.0 - c
            # Rodrigues: R = I + s K + (1 - c) K^2 with K = skew(axis)
            R_j = torch.stack([
                1.0 + one_c * (ax * ax - 1.0),
                -s * az + one_c * (ax * ay),
                s * ay + one_c * (ax * az),
                s * az + one_c * (ax * ay),
                1.0 + one_c * (ay * ay - 1.0),
                -s * ax + one_c * (ay * az),
                -s * ay + one_c * (ax * az),
                s * ax + one_c * (ay * az),
                1.0 + one_c * (az * az - 1.0),
            ]).reshape(3, 3, N)
            R_loc = _matmul3(F, R_j)
        elif jtype == JOINT_PRISMATIC:
            qi = torch.clamp(q_cols[int(q_map[i])], float(model.clamp_lower[i]),
                             float(model.clamp_upper[i]))
            R_loc = F[:, :, None].expand(3, 3, N)
            axis = consts["joint_axis"].to(dev, dtype)[i]
            trans = trans + axis[:, None] * qi[None, :]
        else:
            R_loc = F[:, :, None].expand(3, 3, N)

        p = model.parent_idx[i]
        if p < 0:
            R_w[i] = R_loc
            t_w[i] = trans
        else:
            R_w[i] = _matmul3(R_w[p], R_loc)
            t_w[i] = _matvec3(R_w[p], trans) + t_w[p]
    return R_w, t_w


def offset_points(R_w, t_w, extra_points):
    """World positions R p + t, each (3, N), of points fixed in link frames:
    extra_points [(link, (3,) point in that link's frame), ...] (a grasped
    object's points)."""
    return [_matvec3(R_w[li], p.to(t_w[li].device, t_w[li].dtype)) + t_w[li]
            for li, p in extra_points]


def fk_positions_lanes(model: KinematicModel, q: torch.Tensor,
                       link_idxs=None, extra_points=None):
    """World link positions through the lanes FK chain, then the points
    ``extra_points`` [(link, (3,) local point), ...] (``offset_points``):
    q (..., n_dofs) -> (..., L [+ E], 3)."""
    batch = q.shape[:-1]
    d = q.shape[-1]
    q_cols = q.reshape(-1, d).T
    R_w, t_w = fk_lanes(model, q_cols)
    links = (range(model.n_links) if link_idxs is None
             else [int(x) for x in np.asarray(link_idxs)])
    cols = [t_w[li] for li in links] + offset_points(R_w, t_w,
                                                     extra_points or ())
    flat = torch.stack(cols)                                # (L + E, 3, N)
    return flat.permute(2, 0, 1).reshape(batch + (len(flat), 3))


def fk_points_jacobians_lanes(model: KinematicModel, q: torch.Tensor,
                              extra_points=None):
    """World link positions and their analytic Jacobians through the lanes
    chain: q (..., d) -> (points (..., P, 3), J (..., P, 3, d)), the point
    of link i being its origin, followed by the points ``extra_points``
    [(link, (3,) local point), ...]; columns of joints outside their clamps
    are zero (the clamped FK chain's derivative)."""
    batch = q.shape[:-1]
    d = q.shape[-1]
    q_cols = q.reshape(-1, d).T
    R_w, t_w = fk_lanes(model, q_cols)
    extra = list(extra_points or ())
    links = list(range(model.n_links)) + [li for li, _ in extra]
    pts = torch.stack([t_w[li] for li in range(model.n_links)]
                      + offset_points(R_w, t_w, extra))      # (P, 3, N)
    J = point_jacobians_lanes(model, R_w, t_w, pts, links,
                              q_cols=q_cols)                 # (P, d, 3, N)
    P = len(links)
    return (pts.permute(2, 0, 1).reshape(batch + (P, 3)),
            J.permute(3, 0, 2, 1).reshape(batch + (P, 3, d)))


def point_jacobians_lanes(model: KinematicModel, R_w, t_w,
                          pts: torch.Tensor, point_link_idx: Sequence[int],
                          q_cols=None):
    """Analytic point Jacobians: pts (P, 3, N) owned by links
    ``point_link_idx`` -> J (P, d, 3, N), zero where joint j does not move
    the point's link.  With ``q_cols`` (d, N), columns of joints outside
    [clamp_lower, clamp_upper] (bounds inclusive) are zeroed: the clamped
    FK chain has zero derivative there."""
    ctrl = list(model.controlled_link_idxs())
    q_map = model.q_map
    axes = model.tensors["joint_axis"].to(pts.device, pts.dtype)
    z, origins = [], []
    for li in ctrl:
        zi = _matvec3(R_w[li], axes[li])                    # (3, N)
        if q_cols is not None:
            qj = q_cols[int(q_map[li])]
            in_lim = ((qj >= float(model.clamp_lower[li]))
                      & (qj <= float(model.clamp_upper[li]))).to(qj.dtype)
            zi = zi * in_lim[None, :]
        z.append(zi)
        origins.append(t_w[li])
    Z = torch.stack(z)[None]                                # (1, d, 3, N)
    dx = pts[:, None] - torch.stack(origins)[None]          # (P, d, 3, N)
    zx, zy, zz = Z[:, :, 0], Z[:, :, 1], Z[:, :, 2]
    J = torch.stack([zy * dx[:, :, 2] - zz * dx[:, :, 1],
                     zz * dx[:, :, 0] - zx * dx[:, :, 2],
                     zx * dx[:, :, 1] - zy * dx[:, :, 0]], dim=2)
    prism = [model.joint_types[li] == JOINT_PRISMATIC for li in ctrl]
    if any(prism):
        mask = torch.tensor(prism, device=pts.device)[None, :, None, None]
        J = torch.where(mask, Z.expand_as(J), J)
    anc = model.ancestry_matrix()[list(point_link_idx)]     # (P, d)
    anc_t = torch.as_tensor(anc, device=pts.device)[:, :, None, None]
    return torch.where(anc_t, J, torch.zeros((), dtype=J.dtype,
                                              device=J.device))


def _take(t, idx):
    """t (n, C, M) gathered at idx (M,) over the first axis -> (C, M)."""
    return torch.gather(t, 0, idx[None, None, :].expand(1, t.shape[1],
                                                        t.shape[2]))[0]


def group_sdf_and_grad_lanes(group, x: torch.Tensor):
    """(SDF, gradient) of one primitive group at points x (dim, M) in the
    group's frame (dim = the group's, 2 or 3) -> (val (M,), grad (dim, M)).

    The value is the min over primitives; the gradient is that of the
    minimizing primitive (first index on ties), in closed form:
    spheres (x - c)/||x - c||; sharp boxes sign(x - c) on the maximal axis;
    rounded boxes sign(x - c) times the one-hot maximal axis inside the box
    or relu(q)/||relu(q)|| outside.  Zero-norm points get a zero gradient.
    """
    from ..geom.sdf import RoundedBoxes, SharpBoxes, Spheres
    diff = x[None, :, :] - group.centers[:, :, None]        # (n, 3, M)
    if isinstance(group, Spheres):
        d2 = torch.sum(diff * diff, dim=1)                  # (n, M)
        nz = d2 > 0
        dist = torch.where(nz, torch.sqrt(torch.where(nz, d2, 1.0)), 0.0)
        val, idx = torch.min(dist - group.radii[:, None], dim=0)
        dsel = _take(diff, idx)
        distsel = torch.gather(dist, 0, idx[None])[0]
        grad = torch.where(distsel > 0, dsel / distsel, 0.0)
        return val, grad
    sign = torch.sign(diff)
    if isinstance(group, SharpBoxes):
        t = torch.abs(diff) - group.half_sizes[:, :, None]
        s, amax = torch.max(t, dim=1)                        # (n, M)
        val, idx = torch.min(s, dim=0)
        axis = torch.gather(amax, 0, idx[None])[0]
        onehot = (torch.arange(x.shape[0], device=x.device)[:, None]
                  == axis[None, :]).to(x.dtype)
        return val, _take(sign, idx) * onehot
    if isinstance(group, RoundedBoxes):
        rr = group.round_radii
        q = (torch.abs(diff) - group.half_sizes[:, :, None]) + rr[:, None,
                                                                   None]
        max_q, amax = torch.max(q, dim=1)                    # (n, M)
        rq = torch.relu(q)
        n2 = torch.sum(rq * rq, dim=1)
        nz = n2 > 0
        norm = torch.where(nz, torch.sqrt(torch.where(nz, n2, 1.0)), 0.0)
        s = (torch.clamp(max_q, max=0.0) + norm) - rr[:, None]
        val, idx = torch.min(s, dim=0)
        msel = torch.gather(max_q, 0, idx[None])[0]
        axis = torch.gather(amax, 0, idx[None])[0]
        nsel = torch.gather(norm, 0, idx[None])[0]
        onehot = (torch.arange(x.shape[0], device=x.device)[:, None]
                  == axis[None, :]).to(x.dtype)
        outside = torch.where(nsel > 0, _take(rq, idx) / nsel, 0.0)
        inner = torch.where(msel < 0, onehot, outside)
        return val, _take(sign, idx) * inner
    raise NotImplementedError(type(group))


def _object_sdf_and_grad_lanes(obj, pts: torch.Tensor):
    """Posed ObjectField (SDF, world gradient) at world points (ws_dim, M):
    the points are lifted to 3-D with z = 0, pulled back into the object
    frame and cut to the object's dim; the gradient is rotated back and cut
    to ws_dim, as the reference's vjp through that lift returns it."""
    ws_dim, dim = pts.shape[0], obj.dim
    if ws_dim < 3:
        pts = torch.cat([pts, pts.new_zeros((3 - ws_dim, pts.shape[1]))])
    R = obj.rotation_matrix()                               # (3, 3)
    x_obj = torch.sum(R[:, :, None] * (pts - obj.pos[:, None])[:, None, :],
                      dim=0)[:dim]                          # R^T (x - pos)
    best_v, best_g = None, None
    for f in obj.fields:
        v, g = group_sdf_and_grad_lanes(f, x_obj)
        if best_v is None:
            best_v, best_g = v, g
        else:
            take = v < best_v
            best_g = torch.where(take[None], g, best_g)
            best_v = torch.where(take, v, best_v)
    grad = torch.sum(R[:, :dim, None] * best_g[None, :, :], dim=1)
    return best_v, grad[:ws_dim]


def _grid_cell_index(grid, pts: torch.Tensor):
    """'ij' flat index (M,) of the nearest cell of points pts (>= dim, M),
    in the reference's indexing (grid_map_sdf.py:93-97): per axis
    floor((x - lim0) / extent * cmap) in pts' dtype, clamped."""
    flat = None
    for k, c in enumerate(grid.cmap_dim):
        extent = torch.abs(grid.limits[1, k] - grid.limits[0, k])
        ik = torch.floor((pts[k] - grid.limits[0, k]) / extent * c)
        ik = torch.clamp(ik.to(torch.int64), 0, c - 1)
        flat = ik if flat is None else flat * c + ik
    return flat


def _grid_sdf_lanes(grid, pts: torch.Tensor):
    """Nearest-cell lookup of points (>= dim, M): (the cell's SDF (M,), the
    cell's gradient (dim, M)), in pts' dtype.  Where pts requires grad the
    value is linearised about the points, as the reference's lookup is
    (value the cell's, autograd gradient the cell's gradient)."""
    flat = _grid_cell_index(grid, pts)
    val = grid.sdf_grid.reshape(-1)[flat].to(pts.dtype)
    grad = grid.grad_grid.reshape(-1, grid.dim)[flat].T.to(pts.dtype)
    if pts.requires_grad:
        x = pts[:grid.dim]
        val = val + torch.sum((x - x.detach()) * grad, dim=0)
    return val, grad


def _grid_sdf_value_lanes(grid, pts: torch.Tensor):
    """The cell's SDF alone (M,)."""
    return grid.sdf_grid.reshape(-1)[_grid_cell_index(grid, pts)].to(
        pts.dtype)


def _grid_sdf_lanes_multi(grid, pts: torch.Tensor):
    """``_grid_sdf_lanes`` of P points of N lanes, pts (P, >= dim, N) ->
    (vals (P, N), grads (P, dim, N)), in one gather."""
    P, ws, N = pts.shape
    val, grad = _grid_sdf_lanes(grid, pts.transpose(0, 1).reshape(ws, P * N))
    return val.reshape(P, N), grad.reshape(-1, P, N).transpose(0, 1)


def _grid_sdf_value_lanes_multi(grid, pts: torch.Tensor):
    """``_grid_sdf_value_lanes`` of pts (P, >= dim, N) -> (P, N)."""
    P, ws, N = pts.shape
    return _grid_sdf_value_lanes(
        grid, pts.transpose(0, 1).reshape(ws, P * N)).reshape(P, N)


def sdf_lanes(df_obj_list, pts: torch.Tensor):
    """Min-over-objects SDF (M,) at points (ws_dim, M), without gradient."""
    sdf = None
    for obj in df_obj_list:
        v = (_grid_sdf_value_lanes(obj, pts) if isinstance(obj, GridSDF)
             else obj.signed_distance(pts.T))
        sdf = v if sdf is None else torch.minimum(sdf, v)
    return sdf


def lanes_supported_scene(df_obj_list) -> bool:
    """Every object of the scene is an ObjectField or a GridSDF."""
    from ..geom.sdf import ObjectField
    return all(isinstance(df, (ObjectField, GridSDF)) for df in df_obj_list)


def sdf_and_grad_lanes(df_obj_list, pts: torch.Tensor):
    """(min-over-objects SDF (M,), its gradient (ws_dim, M)) at points
    (ws_dim, M), ws_dim 2 or 3 (a grid's dim is the workspace's); the
    first object attaining the minimum supplies the gradient (a grid: its
    nearest cell's)."""
    best_v, best_g = None, None
    for obj in df_obj_list:
        v, g = (_grid_sdf_lanes(obj, pts) if isinstance(obj, GridSDF)
                else _object_sdf_and_grad_lanes(obj, pts))
        if best_v is None:
            best_v, best_g = v, g
        else:
            take = v < best_v
            best_g = torch.where(take[None], g, best_g)
            best_v = torch.where(take, v, best_v)
    return best_v, best_g


def embed_terms(g_q, Hqq, cost, lam: float, h=None) -> Tuple:
    """Scale unscaled terms (g_q (d, N), Hqq (d, d, N), cost (N,)) by lam and
    embed them into the position part of the m = 2d state.

    h=None: g (m, N), Hb (m, m, N), cost (N,).  h=H (N = H * B, h-major
    lanes): the solver layout g (H, m, B), Hb (H, m, m, B), cost (H, B)."""
    d, N = g_q.shape
    m = 2 * d
    kw = dict(dtype=g_q.dtype, device=g_q.device)
    if h is None:
        g = torch.zeros((m, N), **kw)
        Hb = torch.zeros((m, m, N), **kw)
        g[:d] = lam * g_q
        Hb[:d, :d] = lam * Hqq
        return g, Hb, lam * cost
    Bl = N // h
    g = torch.zeros((h, m, Bl), **kw)
    Hb = torch.zeros((h, m, m, Bl), **kw)
    g[:, :d] = lam * g_q.reshape(d, h, Bl).permute(1, 0, 2)
    Hb[:, :d, :d] = lam * Hqq.reshape(d, d, h, Bl).permute(2, 0, 1, 3)
    return g, Hb, (lam * cost).reshape(h, Bl)


class TermsLayout:
    """Index structure of a robot's residual rows, shared by the plain
    version and the kernel's parameter packing.

    Points are the used links (the sorted union of object- and
    self-collision links, each its link's origin), then a grasped object's G
    points (``point_links`` the grasped link's index, ``extra`` the [(link,
    offset in its frame), ...] of ``offset_points``).  A grasped point is an
    object point and, when the robot has self-collision links, a self point,
    after the links in both sections.  Rows, in order: one SDF hinge per
    object point, one workspace-bound hinge per object point, one distance
    hinge per self-collision pair.  A robot with a learned self-collision
    net (``net``) has no pair rows and no self-collision points; its one net
    row relu(``net_cutoff`` - sd(q)) comes last."""

    def __init__(self, task):
        robot = task.robot
        self.model = robot.model
        self.net = getattr(robot, "self_collision_net", None)
        self.net_cutoff = (None if self.net is None
                           else float(task._NET_SELF_CUTOFF))
        obj_idxs = list(robot.object_coll_idxs)
        self_idxs = ([] if self.net is not None
                     else list(robot.self_coll_idxs or ()))
        self.used_links = sorted(set(obj_idxs + self_idxs))
        self.extra = robot.grasped_extra_points()   # [(link, offset), ...]
        self.n_grasped = len(self.extra)
        self.point_links = self.used_links + [li for li, _ in self.extra]
        n_used = len(self.used_links)
        grasped_pos = list(range(n_used, n_used + self.n_grasped))
        pos = {li: i for i, li in enumerate(self.used_links)}
        self.obj_pos = [pos[li] for li in obj_idxs] + grasped_pos
        pairs = np.asarray(robot.self_pair_idxs if self.net is None else (),
                           np.int64).reshape(-1, 2)
        self_pos = ([pos[li] for li in self_idxs] + grasped_pos
                    if self_idxs else [])
        self.pair_a = [self_pos[a] for a in pairs[:, 0]]
        self.pair_b = [self_pos[b] for b in pairs[:, 1]]
        self.cutoff = float(task.obstacle_cutoff_margin)
        # margin + cutoff, added in float32 like the reference's rows
        self.obj_thresh = robot.object_margins + self.cutoff
        self.self_margins = robot.self_margins[:len(self.pair_a)]
        self.ws_min = task.ws_min
        self.ws_max = task.ws_max
        self.df_obj_list = task.df_obj_list

    def points(self, R_w, t_w):
        """The collision points (P, 3, N) from the lanes FK's link frames:
        the used links' origins, then the grasped points."""
        return torch.stack([t_w[li] for li in self.used_links]
                           + offset_points(R_w, t_w, self.extra))

    def row_joints(self):
        """(a, b), each (R, d) bool over the residual rows in order: the
        joints that move a row's point (a pair's first point) and those that
        move a pair's second point (none for a point row).  A row's Jacobian
        column j is zero unless a[j] or b[j]."""
        anc = self.model.ancestry_matrix()[self.point_links]   # (P, d)
        pt = anc[self.obj_pos]
        pts = [pt, pt] if self.df_obj_list else [pt]
        net = [np.ones((1, anc.shape[1]), bool)] if self.net is not None \
            else []
        a = np.concatenate(pts + [anc[self.pair_a]] + net)
        b = np.concatenate([np.zeros_like(p) for p in pts]
                           + [anc[self.pair_b]]
                           + [np.zeros_like(p) for p in net])
        return a, b


def _contract3(grad, J):
    """grad (K, ws, N) . J (K, d, ws, N) over the workspace axis ->
    (K, d, N)."""
    return torch.sum(grad[:, None] * J, dim=2)


def _pair_hinge(diff, margins):
    """Pair rows from point differences (K, 3, N): (r (K, N), unit
    direction u (K, 3, N), active mask (K, N))."""
    d2 = torch.sum(diff * diff, dim=1)
    nz = d2 > 0
    dist = torch.where(nz, torch.sqrt(torch.where(nz, d2, 1.0)), 0.0)
    inv = torch.where(nz, 1.0 / torch.clamp(dist, min=1e-9), 0.0)
    r = torch.relu(margins[:, None] - dist)
    return r, diff * inv[:, None], (r > 0).to(diff.dtype)


def _workspace_val_grad(pts, ws_min, ws_max):
    """Min-face workspace distance of points (P, ws, N) and its gradient
    (P, ws, N); the first minimal face wins."""
    ws = pts.shape[1]
    faces = torch.cat([pts - ws_min[None, :, None],
                       ws_max[None, :, None] - pts], dim=1)
    val, amin = torch.min(faces, dim=1)                          # (P, N)
    sign = torch.where(amin < ws, 1.0, -1.0).to(pts.dtype)
    axis_id = torch.where(amin < ws, amin, amin - ws)
    grad = torch.stack([sign * (axis_id == k).to(pts.dtype)
                        for k in range(ws)], dim=1)
    return val, grad


def hinge_rows(lay, pts, J, q_cols=None):
    """Hinge rows of collision points pts (P, ws, N) with Jacobians
    J (P, d, ws, N): one SDF row per object point (when the scene has
    objects), one workspace row per object point, one distance row per
    pair, in that order, then the learned self-collision net's row of
    q_cols (d, N) where ``lay.net`` is set (q_cols is then required).
    ``lay`` carries ``obj_pos``, ``pair_a``, ``pair_b`` (indices into
    pts), ``obj_thresh``, ``self_margins``, ``ws_min``, ``ws_max``,
    ``df_obj_list``, ``net`` and ``net_cutoff``.
    -> (r (R, N), Jr (R, d, N))."""
    N = pts.shape[-1]
    rows_r, rows_J = [], []

    def hinge(val, grad, J_sub):
        """val (P, N), grad (P, ws, N), J_sub (P, d, ws, N)."""
        r = torch.relu(lay.obj_thresh[:, None] - val)
        act = (r > 0).to(val.dtype)
        rows_r.append(r)
        rows_J.append(-act[:, None, :] * _contract3(grad, J_sub))

    # the scene and the workspace rows read a point's first ws_dim
    # coordinates and its Jacobian's first ws_dim rows (a 3-D robot in a
    # 2-D scene is cut to the plane); the pairs read all three
    ws = lay.ws_min.shape[0]
    obj_pts = pts[lay.obj_pos][:, :ws]                          # (Po, ws, N)
    J_obj = J[lay.obj_pos][:, :, :ws]
    Po = obj_pts.shape[0]
    if lay.df_obj_list:
        flat = obj_pts.permute(1, 0, 2).reshape(ws, Po * N)
        val, grad = sdf_and_grad_lanes(lay.df_obj_list, flat)
        hinge(val.reshape(Po, N), grad.reshape(ws, Po, N).permute(1, 0, 2),
              J_obj)
    hinge(*_workspace_val_grad(obj_pts, lay.ws_min, lay.ws_max), J_obj)
    if len(lay.pair_a):
        r_s, u, act = _pair_hinge(pts[lay.pair_a] - pts[lay.pair_b],
                                  lay.self_margins)
        rows_r.append(r_s)
        rows_J.append(-act[:, None, :]
                      * _contract3(u, J[lay.pair_a] - J[lay.pair_b]))
    if lay.net is not None:
        if q_cols is None:
            raise ValueError("a layout with a learned self-collision net "
                             "needs q_cols for its row")
        r_n, Jr_n = net_rows(lay.net, q_cols, lay.net_cutoff)
        rows_r.append(r_n[None])
        rows_J.append(Jr_n[None])
    return torch.cat(rows_r), torch.cat(rows_J)


class PointMassLayout:
    """Row structure of a point-mass task: its one collision point (the
    configuration), an SDF row when the scene has objects and a workspace
    row; no pairs, no chain structure."""

    def __init__(self, task):
        self.obj_pos = [0]
        self.pair_a, self.pair_b = [], []
        self.net = None
        self.obj_thresh = (task.robot.object_margins
                           + float(task.obstacle_cutoff_margin))
        self.ws_min = task.ws_min
        self.ws_max = task.ws_max
        self.df_obj_list = task.df_obj_list


def obstacle_terms_lanes_factory(task):
    """Plain-PyTorch GN obstacle terms of a task.

    Returns terms(q_cols (d, N), lam, h=None) -> (g, Hb, cost) in the layout
    of ``embed_terms``, or None when the robot has no lanes path (it needs a
    kinematic model whose collision points are link origins, or is a point
    mass, whose point is q and whose Jacobian is the identity).  A
    ``MultiRobot`` whose members all have kinematic models takes the
    block-structured terms (``obstacle_terms_lanes_multirobot_factory``),
    or, where a mutual pair joins two object points of one member (which
    that assembly declines with a warning), the generic padded assembly:
    every collision point's Jacobian padded to the full d columns
    (``MultiRobotLayout.padded_points``) and g, Hqq and the cost reduced
    over every row, rows in the reference's order."""
    from ..robots.multi_robot import MultiRobot
    from ..robots.point_mass import RobotPointMass
    robot = task.robot
    if isinstance(robot, RobotPointMass):
        lay = PointMassLayout(task)

        def points_and_jacobians(q_cols):
            d, N = q_cols.shape
            eye = torch.eye(d, dtype=q_cols.dtype, device=q_cols.device)
            return q_cols[None], eye[None, :, :, None].expand(1, d, d, N)
    elif isinstance(robot, MultiRobot):
        if not all(hasattr(r, "model") for r in robot.robots):
            return None
        structured = obstacle_terms_lanes_multirobot_factory(task,
                                                             strict=False)
        if structured is not None:
            return structured
        lay = MultiRobotLayout(task)
        points_and_jacobians = lay.padded_points
    elif not hasattr(robot, "model") or robot.object_interpolate:
        return None
    else:
        lay = TermsLayout(task)
        model = lay.model

        def points_and_jacobians(q_cols):
            R_w, t_w = fk_lanes(model, q_cols)
            pts = lay.points(R_w, t_w)                             # (P,3,N)
            return pts, point_jacobians_lanes(model, R_w, t_w, pts,
                                              lay.point_links, q_cols=q_cols)

    def terms(q_cols, lam, h=None):
        return embed_terms(*unscaled_terms(q_cols), lam, h=h)

    def unscaled_terms(q_cols):
        """q_cols (d, N) -> (g_q = sum r Jr (d, N), Hqq = Jr^T Jr (d, d, N),
        cost = 0.5 sum r^2 (N,))."""
        r, Jr = residual_rows(q_cols)
        g_q = torch.sum(r[:, None] * Jr, dim=0)
        Hqq = torch.sum(Jr[:, :, None] * Jr[:, None, :], dim=0)
        cost = 0.5 * torch.sum(r * r, dim=0)
        return g_q, Hqq, cost

    def residual_rows(q_cols):
        """q_cols (d, N) -> hinge residuals r (R, N) and their Jacobians
        Jr (R, d, N), rows in TermsLayout's order (the object SDF rows only
        when the scene has objects, the net row only with a net)."""
        return hinge_rows(lay, *points_and_jacobians(q_cols), q_cols)

    terms.unscaled = unscaled_terms
    terms.rows = residual_rows
    terms.layout = lay
    return terms


def member_collision_points(r, section: str):
    """[(link, grasped point index or -1), ...]: the points of robot r's
    object ("object") or self ("self") section in its ``fk_map_collision``
    layout, the section's links then a grasped object's G points on the
    grasped link (in a self section only when r has self-collision
    links)."""
    links = list(r.object_coll_idxs if section == "object"
                 else (r.self_coll_idxs or ()))
    out = [(li, -1) for li in links]
    G = int(getattr(r, "grasped_n_points", 0))
    if G and (section == "object" or links):
        gi = r.model.link_index(r.link_name_grasped_object)
        out += [(gi, g) for g in range(G)]
    return out


def _member_lanes_points(r, q_cols_i, R_b, t_b):
    """FK and world transforms of one multi-robot member: r has ``.model``;
    q_cols_i (d_i, N); R_b (3, 3), t_b (3,) its base pose.  -> (world link
    rotations, world link translations, object points, their link ids,
    self points, their link ids), the points lists of (3, N) in the
    member's ``fk_map_collision`` layout (a grasped point R_wW p + t_wW of
    its link's world frame)."""
    R_w, t_w = fk_lanes(r.model, q_cols_i)
    R_wW = [_matmul3(R_b, R) for R in R_w]
    t_wW = [_matvec3(R_b, t) + t_b[:, None] for t in t_w]

    def section(name):
        pts, ids = [], []
        for li, g in member_collision_points(r, name):
            pts.append(t_wW[li] if g < 0 else offset_points(
                R_wW, t_wW, [(li, r.grasped_points[g])])[0])
            ids.append(li)
        return pts, ids

    obj, obj_ids = section("object")
    slf, self_ids = section("self")
    return R_wW, t_wW, obj, obj_ids, slf, self_ids


class MultiRobotLayout:
    """Row structure of a ``MultiRobot`` task, shared by the plain terms
    and the kernel's parameter packing.

    Per member i: object rows (SDF hinge and workspace hinge per object
    point) and its own self-collision pairs, in member-local point indices
    (object points first, then self points).  Mutual pairs are grouped by
    (member of the first point, member of the second) in first-seen order,
    in object-local indices.  A mutual pair whose points are object points
    of one member is in none of these groups: ``same_member`` lists each as
    (its index in the pair list, its two points, the member), and the
    block-structured terms decline a layout that has one, as the
    reference's do."""

    def __init__(self, task):
        robot = task.robot
        self.robot = robot
        self.members = robot.robots
        self.d_list = [r.q_dim for r in self.members]
        self.d_off = np.cumsum([0] + self.d_list)
        self.obj_counts = list(robot.obj_counts)
        self.self_counts = list(robot.self_counts)
        n_obj = sum(self.obj_counts)
        self.obj_off = np.cumsum([0] + self.obj_counts)
        self.self_off = n_obj + np.cumsum([0] + self.self_counts)
        margins = robot.self_margins.cpu().numpy()
        self.own_pairs = [[] for _ in self.members]   # (a, b, margin)
        self.groups = {}                              # (i, j) -> rows
        self.same_member = []                         # (k, a, b, member)
        for k, (pa, pb) in enumerate(robot.self_pair_idxs):
            mg = float(margins[k])
            if pa >= n_obj:
                i = int(np.searchsorted(self.self_off, pa, side="right")) - 1
                base = self.obj_counts[i] - int(self.self_off[i])
                self.own_pairs[i].append((pa + base, pb + base, mg))
                continue
            i = int(np.searchsorted(self.obj_off, pa, side="right")) - 1
            j = int(np.searchsorted(self.obj_off, pb, side="right")) - 1
            if i == j:
                self.same_member.append((k, pa, pb, i))
                continue
            self.groups.setdefault((i, j), []).append(
                (pa - int(self.obj_off[i]), pb - int(self.obj_off[j]), mg))
        self.cutoff = float(task.obstacle_cutoff_margin)
        self.ws_min, self.ws_max = task.ws_min, task.ws_max
        self.df_obj_list = task.df_obj_list
        # the full collision layout, for the residual rows in the
        # reference's order (object rows, workspace rows, pairs as listed)
        self.obj_pos = list(range(n_obj))
        pairs = np.asarray(robot.self_pair_idxs, np.int64).reshape(-1, 2)
        self.pair_a, self.pair_b = list(pairs[:, 0]), list(pairs[:, 1])
        self.obj_thresh = robot.object_margins + self.cutoff
        self.self_margins = robot.self_margins
        self.net = None      # no MultiRobot row reads a member's net

    def member_points(self, q_cols):
        """Per member: points (P_i, 3, N) (object then self) and
        member-width Jacobians (P_i, d_i, 3, N)."""
        out = []
        for i, r in enumerate(self.members):
            q_i = q_cols[int(self.d_off[i]):int(self.d_off[i + 1])]
            R_b = self.robot.base_rots[i].to(q_cols.dtype)
            t_b = self.robot.base_trans[i].to(q_cols.dtype)
            R_wW, t_wW, obj, obj_ids, slf, self_ids = _member_lanes_points(
                r, q_i, R_b, t_b)
            pts = torch.stack(obj + slf)
            out.append((pts, point_jacobians_lanes(
                r.model, R_wW, t_wW, pts, obj_ids + self_ids, q_cols=q_i)))
        return out

    def padded_points(self, q_cols):
        """The full collision layout's points (P, 3, N) (every member's
        object section, then every member's self section) and their
        Jacobians padded to the full width, (P, d, 3, N)."""
        members = self.member_points(q_cols)
        d = int(self.d_off[-1])
        pts, J = [], []
        for section in (0, 1):                  # object sections, then self
            for i, (p, Jm) in enumerate(members):
                P_obj = self.obj_counts[i]
                cut = slice(0, P_obj) if section == 0 else slice(P_obj, None)
                lo, hi = int(self.d_off[i]), int(self.d_off[i + 1])
                pts.append(p[cut])
                J.append(torch.nn.functional.pad(Jm[cut],
                                                 [0, 0, 0, 0, lo, d - hi]))
        return torch.cat(pts), torch.cat(J)

    def point_joints(self):
        """(P, d) bool over the full collision layout: the joints that move
        each point (its member's ancestry, at the member's columns)."""
        d = int(self.d_off[-1])
        rows = []
        for section in ("object", "self"):
            for i, r in enumerate(self.members):
                anc = r.model.ancestry_matrix()
                for li, _ in member_collision_points(r, section):
                    row = np.zeros(d, bool)
                    row[int(self.d_off[i]):int(self.d_off[i + 1])] = anc[li]
                    rows.append(row)
        return np.stack(rows)

    def row_joints(self):
        """(a, b) as ``TermsLayout.row_joints``, over the rows of the plain
        terms' ``rows`` (object SDF rows when the scene has objects,
        workspace rows, pairs)."""
        anc = self.point_joints()
        pt = anc[self.obj_pos]
        pts = [pt, pt] if self.df_obj_list else [pt]
        a = np.concatenate(pts + [anc[self.pair_a]])
        b = np.concatenate([np.zeros_like(p) for p in pts]
                           + [anc[self.pair_b]])
        return a, b


def obstacle_terms_lanes_multirobot_factory(task, strict: bool = True):
    """Block-structured plain-PyTorch GN obstacle terms of a ``MultiRobot``
    task (the plain version of the CUDA MultiRobot terms kernel).

    Every collision point moves with one member, so its Jacobian has that
    member's d_i columns only.  Member rows (object SDF, workspace, own
    pairs) add to the diagonal block H_ii; each mutual group (i, j) adds to
    H_ii, H_jj and the cross block H_ij.  Same contract as
    ``obstacle_terms_lanes_factory``: terms(q_cols (d, N), lam, h=None),
    with ``.unscaled`` and ``.rows``; None unless every member has a
    kinematic model.

    A mutual pair between two object points of one member is not a cross
    block's: with ``strict`` this assembly raises ValueError for it, as the
    reference's does; without, it warns in the reference's words and
    returns None, and ``obstacle_terms_lanes_factory`` takes the generic
    padded assembly, which is right for such a pair."""
    from ..robots.multi_robot import MultiRobot
    robot = task.robot
    if not isinstance(robot, MultiRobot) or not all(
            hasattr(r, "model") for r in robot.robots):
        return None
    lay = MultiRobotLayout(task)
    if lay.same_member:
        _, pa, pb, i = lay.same_member[0]
        msg = ("mutual pair (%d, %d) indexes object points of the same "
               "member %d; encode same-member pairs via the member's "
               "self-collision section instead" % (pa, pb, i))
        if strict:
            raise ValueError(msg)
        warnings.warn(msg + " (falling back to the generic padded "
                      "assembly)", stacklevel=2)
        return None
    n_mem = len(lay.members)
    d = robot.q_dim

    def unscaled(q_cols):
        """q_cols (d, N) -> (g_q (d, N), Hqq (d, d, N), cost (N,)),
        unscaled by the collision weight."""
        dtype = q_cols.dtype
        N = q_cols.shape[-1]
        ws = lay.ws_min.shape[0]
        members = lay.member_points(q_cols)

        sdf_val, sdf_grad = [None] * n_mem, [None] * n_mem
        if lay.df_obj_list:
            obj = torch.cat([p[:lay.obj_counts[i], :ws]
                             for i, (p, _) in enumerate(members)])
            n_obj = obj.shape[0]
            val, grad = sdf_and_grad_lanes(
                lay.df_obj_list, obj.permute(1, 0, 2).reshape(ws, n_obj * N))
            val = val.reshape(n_obj, N)
            grad = grad.reshape(ws, n_obj, N).permute(1, 0, 2)
            for i in range(n_mem):
                lo, hi = int(lay.obj_off[i]), int(lay.obj_off[i + 1])
                sdf_val[i], sdf_grad[i] = val[lo:hi], grad[lo:hi]

        member_rows = []                   # (r (R_i, N), Jr (R_i, d_i, N))
        for i, (pts, J) in enumerate(members):
            P_obj = lay.obj_counts[i]
            # cut to the scene's ws_dim, as hinge_rows
            obj_pts, J_obj = pts[:P_obj, :ws], J[:P_obj, :, :ws]
            # margin + cutoff in q's dtype, as the reference's structured
            # terms add them
            thresh = (lay.members[i].object_margins.to(dtype)
                      + lay.cutoff)[:, None]
            rs, Jrs = [], []

            def hinge(val, grad):
                r = torch.relu(thresh - val)
                act = (r > 0).to(dtype)
                rs.append(r)
                Jrs.append(-act[:, None, :] * _contract3(grad, J_obj))

            if lay.df_obj_list:
                hinge(sdf_val[i], sdf_grad[i])
            hinge(*_workspace_val_grad(obj_pts, lay.ws_min.to(dtype),
                                       lay.ws_max.to(dtype)))
            if lay.own_pairs[i]:
                a, b, mg = zip(*lay.own_pairs[i])
                r_s, u, act = _pair_hinge(
                    pts[list(a)] - pts[list(b)],
                    torch.tensor(mg, dtype=torch.float32).to(
                        q_cols.device, dtype))
                rs.append(r_s)
                Jrs.append(-act[:, None, :]
                           * _contract3(u, J[list(a)] - J[list(b)]))
            member_rows.append((torch.cat(rs), torch.cat(Jrs)))

        mutual_rows = {}                   # (i, j) -> (r, A (K, d_i, N), B)
        for (i, j), rows in lay.groups.items():
            a, b, mg = zip(*rows)
            pts_i, J_i = members[i]
            pts_j, J_j = members[j]
            r_m, u, act = _pair_hinge(
                pts_i[list(a)] - pts_j[list(b)],
                torch.tensor(mg, dtype=torch.float32).to(q_cols.device,
                                                         dtype))
            mutual_rows[(i, j)] = (
                r_m, -act[:, None, :] * _contract3(u, J_i[list(a)]),
                act[:, None, :] * _contract3(u, J_j[list(b)]))

        def reduce_g(r, Jr):
            return torch.sum(r[:, None] * Jr, dim=0)

        def reduce_h(A, B):
            return torch.sum(A[:, :, None] * B[:, None, :], dim=0)

        g = torch.zeros((d, N), dtype=dtype, device=q_cols.device)
        Hqq = torch.zeros((d, d, N), dtype=dtype, device=q_cols.device)
        cost = torch.zeros((N,), dtype=dtype, device=q_cols.device)
        sl = [slice(int(lay.d_off[i]), int(lay.d_off[i + 1]))
              for i in range(n_mem)]
        for i, (r, Jr) in enumerate(member_rows):
            g[sl[i]] += reduce_g(r, Jr)
            Hqq[sl[i], sl[i]] += reduce_h(Jr, Jr)
            cost += torch.sum(r * r, dim=0)
        for (i, j), (r, A, Bm) in mutual_rows.items():
            g[sl[i]] += reduce_g(r, A)
            g[sl[j]] += reduce_g(r, Bm)
            Hqq[sl[i], sl[i]] += reduce_h(A, A)
            Hqq[sl[j], sl[j]] += reduce_h(Bm, Bm)
            cross = reduce_h(A, Bm)
            Hqq[sl[i], sl[j]] += cross
            Hqq[sl[j], sl[i]] += cross.transpose(0, 1)
            cost += torch.sum(r * r, dim=0)
        return g, Hqq, 0.5 * cost

    def terms(q_cols, lam, h=None):
        return embed_terms(*unscaled(q_cols), lam, h=h)

    def residual_rows(q_cols):
        """q_cols (d, N) -> (r (R, N), Jr (R, d, N)) over the full collision
        layout, rows in the reference's order: object SDF rows, workspace
        rows, then the pairs as ``self_pair_idxs`` lists them."""
        return hinge_rows(lay, *lay.padded_points(q_cols))

    terms.unscaled = unscaled
    terms.rows = residual_rows
    terms.layout = lay
    return terms
