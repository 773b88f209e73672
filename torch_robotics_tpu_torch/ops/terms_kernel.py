"""Fused GN obstacle-terms kernel and value-only collision-cost kernel:
wrappers, parameter packing, dispatch.

Counterparts of torch_robotics_tpu/ops/pallas_terms.py
(``obstacle_terms_pallas_factory`` and ``collision_cost_pallas_factory``,
the TPU kernels they replace).  The CUDA source of both is
``csrc/terms.cu``; its head comment says what bounds each on the H100 and
how its design answers that.  The plain PyTorch version of both is
``ops/lanes_fk.obstacle_terms_lanes_factory`` (the cost kernel's is the
cost output of its unscaled terms).

The returned ``terms(q_cols, lam, h=None)`` keeps the reference contract:
the kernel writes the unscaled g (d, N), Hqq (d, d, N) and cost (N); the
wrapper applies lam and embeds them into g (H, m, B), Hb (H, m, m, B),
cost (H, B) (or the h=None lanes layout).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``collision_cost_kernel_factory(task, terms=None)`` returns ``cost(q_cols (d, N)) ->
(N,)``, 0.5 sum r^2 over the same rows, unscaled, with the same dispatch.
It is not differentiable: solvers that need gradients use the terms.

For a ``MultiRobot`` the terms come from ``multirobot_terms_kernel_factory``
with the same contract: its CUDA source is ``csrc/mr_terms.cu`` (which
replaces ``_multirobot_terms_pallas_factory``), its plain version
``ops/lanes_fk.obstacle_terms_lanes_multirobot_factory``.  The value-only
cost of a ``MultiRobot`` (the MultiRobot branch of
``collision_cost_pallas_factory``) is the value-only variant of the same
kernel, and its plain version the cost output of those plain terms.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaKernel
from .lanes_fk import (MultiRobotLayout, TermsLayout, embed_terms,
                       obstacle_terms_lanes_factory,
                       obstacle_terms_lanes_multirobot_factory)

__all__ = ["KERNEL", "COST_KERNEL", "MR_KERNEL", "MR_COST_KERNEL", "MAX_DOF",
           "MR_MAX_MEMBERS", "obstacle_terms_kernel_factory",
           "collision_cost_kernel_factory", "multirobot_terms_kernel_factory",
           "pack_terms_params", "pack_multirobot_params", "run_terms_kernel",
           "run_cost_kernel", "run_multirobot_terms_kernel",
           "run_multirobot_cost_kernel"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("terms.cu", {
    "trt_terms_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                         _P],
})
COST_KERNEL = CudaKernel("terms.cu", {
    "trt_cost_launch": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
})
MR_KERNEL = CudaKernel("mr_terms.cu", {
    "trt_mr_terms_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _P, _P, _P],
})
MR_COST_KERNEL = CudaKernel("mr_terms.cu", {
    "trt_mr_cost_launch": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _P, _P, _P],
})
MAX_DOF = 8        # terms.cu instantiates D = 1..8; mr_terms.cu kMaxDof
MR_MAX_MEMBERS = 4  # mr_terms.cu kMaxMembers
_MR_LANES = 32      # mr_terms.cu kLanes
_MAX_LINKS = 32    # terms.cu kMaxLinks
_GROUP_KIND = {"Spheres": 0, "RoundedBoxes": 1, "SharpBoxes": 2}


def _pack_scene(df_obj_list):
    """Scene primitives -> (ints: object group ranges, group kinds, counts,
    offsets; floats: object rotations, positions, primitive tables), the
    scene sections of the packed buffers."""
    from ..geom.sdf import ObjectField
    group_kind, group_count, group_off, obj_begin = [], [], [], [0]
    obj_rot, obj_pos, prims = [], [], []
    n_prims = 0
    for obj in df_obj_list:
        if not isinstance(obj, ObjectField):
            raise NotImplementedError(
                "grid-SDF extras are not in the CUDA terms kernels yet")
        if obj.dim != 3:
            raise NotImplementedError("the CUDA terms kernels take 3-D scenes")
        obj_rot.append(obj.rotation_matrix().cpu().numpy().reshape(9))
        obj_pos.append(obj.pos.cpu().numpy())
        for f in obj.fields:
            kind = type(f).__name__
            cols = [f.centers, f.radii[:, None]] if kind == "Spheres" else (
                [f.centers, f.half_sizes, f.round_radii[:, None]]
                if kind == "RoundedBoxes" else [f.centers, f.half_sizes])
            table = torch.cat(cols, dim=1).cpu().numpy()
            group_kind.append(_GROUP_KIND[kind])
            group_count.append(table.shape[0])
            group_off.append(n_prims)
            prims.append(table.reshape(-1))
            n_prims += table.size
        obj_begin.append(len(group_kind))
    ints = [obj_begin, group_kind, group_count, group_off]
    floats = [np.zeros(0) if not obj_rot else np.stack(obj_rot),
              np.zeros(0) if not obj_pos else np.stack(obj_pos),
              np.zeros(0) if not prims else np.concatenate(prims)]
    return ints, floats


def _i32(sections):
    return np.concatenate([np.asarray(s, np.int64).reshape(-1)
                           for s in sections]).astype(np.int32)


def _f32(sections):
    return np.concatenate([np.asarray(s, np.float32).reshape(-1)
                           for s in sections])


def pack_terms_params(lay: TermsLayout):
    """Model + scene + collision rows -> (ints int32, floats float32), the
    two buffers ``terms.cu`` reads (section order as in its parse_layout)."""
    model = lay.model
    L = model.n_links
    ctrl = list(model.controlled_link_idxs())
    D = len(ctrl)
    anc = model.ancestry_matrix()
    q_idx = np.full(L, -1, np.int64)
    q_idx[ctrl] = np.arange(D)
    scene_i, scene_f = _pack_scene(lay.df_obj_list)

    header = [L, D, len(lay.used_links), len(lay.obj_pos), len(lay.pair_a),
              len(lay.df_obj_list), len(scene_i[1]), 0]
    anc_bits = [int(sum(1 << j for j in range(D) if anc[li, j]))
                for li in lay.used_links]
    ints = _i32([header, model.topological_order(), model.parent_idx,
                 model.joint_types, q_idx, ctrl, lay.used_links, anc_bits,
                 lay.obj_pos, lay.pair_a, lay.pair_b] + scene_i)
    floats = _f32([model.joint_trans, model.joint_fixed_rot, model.joint_axis,
                   model.clamp_lower, model.clamp_upper,
                   lay.obj_thresh.cpu().numpy(),
                   lay.self_margins.cpu().numpy(), lay.ws_min.cpu().numpy(),
                   lay.ws_max.cpu().numpy()] + scene_f)
    return ints, floats


def pack_multirobot_params(lay: MultiRobotLayout):
    """Members' models + base poses + row groups + scene -> (ints int32,
    floats float32), the two buffers ``mr_terms.cu`` reads (section order as
    in its parse_layout).  Block pairs: the n diagonal blocks, then the
    cross blocks (i, j), i < j, in order; each cross block's mutual rows are
    stored with their first point on member i (a pair listed the other way
    round is swapped, which leaves its row unchanged)."""
    robot = lay.robot
    members = lay.members
    n_mem = len(members)
    models = [r.model for r in members]
    L_list = [m.n_links for m in models]
    l_off = np.cumsum([0] + L_list)
    topo, parent, jtype, qidx, ctrl = [], [], [], [], []
    for m in models:
        c = list(m.controlled_link_idxs())
        qi = np.full(m.n_links, -1, np.int64)
        qi[c] = np.arange(len(c))
        topo += list(m.topological_order())
        parent += list(m.parent_idx)
        jtype += list(m.joint_types)
        qidx += list(qi)
        ctrl += c

    # the full collision layout: object sections, then self sections
    pt_member, pt_link, pt_anc = [], [], []
    for section in ("object_coll_idxs", "self_coll_idxs"):
        for i, (r, m) in enumerate(zip(members, models)):
            anc = m.ancestry_matrix()
            for li in getattr(r, section) or ():
                pt_member.append(i)
                pt_link.append(li)
                pt_anc.append(int(sum(1 << j for j in range(m.n_dofs)
                                      if anc[li, j])))
    obj_off = [int(v) for v in lay.obj_off]
    self_off = [int(v) for v in lay.self_off]

    own_a, own_b, own_m, own_range = [], [], [], []
    for i, rows in enumerate(lay.own_pairs):
        begin = len(own_a)
        for a, b, mg in rows:          # member-local: self section after obj
            to_full = self_off[i] - lay.obj_counts[i]
            own_a.append(a + to_full)
            own_b.append(b + to_full)
            own_m.append(mg)
        own_range.append((begin, len(own_a)))

    bp = [(i, i) for i in range(n_mem)] + [
        (i, j) for i in range(n_mem) for j in range(i + 1, n_mem)]
    mut_a, mut_b, mut_m, bp_range = [], [], [], []
    for i, j in bp:
        begin = len(mut_a)
        if i != j:
            for a, b, mg in lay.groups.get((i, j), ()):
                mut_a.append(obj_off[i] + a)
                mut_b.append(obj_off[j] + b)
                mut_m.append(mg)
            for b, a, mg in lay.groups.get((j, i), ()):
                mut_a.append(obj_off[i] + a)
                mut_b.append(obj_off[j] + b)
                mut_m.append(mg)
        bp_range.append((begin, len(mut_a)))

    scene_i, scene_f = _pack_scene(lay.df_obj_list)
    n_obj = obj_off[-1]
    header = [n_mem, robot.q_dim, len(pt_member), n_obj, len(own_a),
              len(mut_a), len(lay.df_obj_list), len(scene_i[1]), len(bp),
              int(l_off[-1])] + [0] * 6
    ints = _i32([header, L_list, lay.d_list, lay.d_off[:-1], l_off[:-1],
                 obj_off[:-1], obj_off[1:],
                 [b for b, _ in own_range], [e for _, e in own_range],
                 [i for i, _ in bp], [j for _, j in bp],
                 [b for b, _ in bp_range], [e for _, e in bp_range],
                 topo, parent, jtype, qidx, ctrl, pt_member, pt_link, pt_anc,
                 own_a, own_b, mut_a, mut_b] + scene_i)
    floats = _f32(
        [np.concatenate([m.joint_trans.reshape(-1) for m in models]),
         np.concatenate([m.joint_fixed_rot.reshape(-1) for m in models]),
         np.concatenate([m.joint_axis.reshape(-1) for m in models]),
         np.concatenate([m.clamp_lower for m in models]),
         np.concatenate([m.clamp_upper for m in models]),
         robot.base_rots.cpu().numpy(), robot.base_trans.cpu().numpy(),
         lay.obj_thresh.cpu().numpy(), own_m, mut_m,
         lay.ws_min.cpu().numpy(), lay.ws_max.cpu().numpy()] + scene_f)
    return ints, floats


def mr_shared_bytes(ints, cost_only: bool = False) -> int:
    """Dynamic shared memory of one mr_terms.cu block: points, joint axes
    and origins (3 floats each, per lane; the value-only kernel keeps no
    axes or origins) and the per-warp cost shares."""
    P, D, n_bp = int(ints[2]), int(ints[1]), int(ints[8])
    return 4 * _MR_LANES * (3 * P + (0 if cost_only else 6 * D) + n_bp)


def _check_q(q_cols, ints, floats, d: int):
    if q_cols.device.type != "cuda":
        raise ValueError("the terms.cu kernels take CUDA tensors")
    if q_cols.dtype != torch.float32 or not q_cols.is_contiguous():
        raise ValueError("q_cols must be contiguous float32")
    if q_cols.dim() != 2 or q_cols.shape[0] != d:
        raise ValueError("q_cols must be (%d, N), got %s"
                         % (d, tuple(q_cols.shape)))
    if ints.device != q_cols.device or floats.device != q_cols.device:
        raise ValueError("the task's kernel parameters live on %s, q_cols "
                         "on %s" % (ints.device, q_cols.device))


def run_terms_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                     floats: torch.Tensor, d: int):
    """Launch the CUDA terms kernel: q_cols (d, N) float32 contiguous CUDA
    -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,))."""
    _check_q(q_cols, ints, floats, d)
    N = q_cols.shape[1]
    g = torch.empty((d, N), dtype=torch.float32, device=q_cols.device)
    Hqq = torch.empty((d, d, N), dtype=torch.float32, device=q_cols.device)
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return g, Hqq, cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("trt_terms_launch", q_cols.data_ptr(), g.data_ptr(),
                      Hqq.data_ptr(), cost.data_ptr(), N, d, ints.data_ptr(),
                      floats.data_ptr(), stream)
    return g, Hqq, cost


def run_cost_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                    floats: torch.Tensor, d: int):
    """Launch the CUDA value-only cost kernel: q_cols (d, N) float32
    contiguous CUDA -> unscaled cost (N,)."""
    _check_q(q_cols, ints, floats, d)
    N = q_cols.shape[1]
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        COST_KERNEL.launch("trt_cost_launch", q_cols.data_ptr(),
                           cost.data_ptr(), N, d, ints.data_ptr(),
                           floats.data_ptr(), stream)
    return cost


def run_multirobot_terms_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                                floats: torch.Tensor, d: int, n_bp: int,
                                shared_bytes: int):
    """Launch the CUDA MultiRobot terms kernel: q_cols (d, N) float32
    contiguous CUDA -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,))."""
    _check_q(q_cols, ints, floats, d)
    N = q_cols.shape[1]
    g = torch.empty((d, N), dtype=torch.float32, device=q_cols.device)
    Hqq = torch.empty((d, d, N), dtype=torch.float32, device=q_cols.device)
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return g, Hqq, cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        MR_KERNEL.launch("trt_mr_terms_launch", q_cols.data_ptr(),
                         g.data_ptr(), Hqq.data_ptr(), cost.data_ptr(), N,
                         n_bp, shared_bytes, ints.data_ptr(),
                         floats.data_ptr(), stream)
    return g, Hqq, cost


def run_multirobot_cost_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                               floats: torch.Tensor, d: int, n_bp: int,
                               shared_bytes: int):
    """Launch the CUDA MultiRobot value-only cost kernel: q_cols (d, N)
    float32 contiguous CUDA -> unscaled cost (N,)."""
    _check_q(q_cols, ints, floats, d)
    N = q_cols.shape[1]
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        MR_COST_KERNEL.launch("trt_mr_cost_launch", q_cols.data_ptr(),
                              cost.data_ptr(), N, n_bp, shared_bytes,
                              ints.data_ptr(), floats.data_ptr(), stream)
    return cost


def _kernel_params(task):
    """(d, ints, floats, plain terms) of a task the terms.cu kernels take,
    or None where the reference's fused factories return None (a point
    mass, robots without a kinematic model, interpolated collision points).
    The learned self-collision row, grid-SDF scenes and grasped-object
    points are not in the kernels yet and raise NotImplementedError."""
    from ..robots.point_mass import RobotPointMass
    robot = task.robot
    if isinstance(robot, RobotPointMass):
        return None
    if not hasattr(robot, "model") or robot.object_interpolate:
        return None
    if getattr(robot, "self_collision_net", None) is not None:
        raise NotImplementedError(
            "the learned self-collision row is not in the CUDA terms kernel")
    if getattr(robot, "grasped_n_points", 0) > 0:
        raise NotImplementedError(
            "grasped-object points are not in the CUDA terms kernel")
    lay = TermsLayout(task)
    d = lay.model.n_dofs
    if d > MAX_DOF or lay.model.n_links > _MAX_LINKS:
        raise NotImplementedError(
            "the CUDA terms kernel takes at most %d joints and %d links"
            % (MAX_DOF, _MAX_LINKS))
    ints_np, floats_np = pack_terms_params(lay)
    ints = torch.as_tensor(ints_np, device=task.device)
    floats = torch.as_tensor(floats_np, device=task.device)
    return d, ints, floats, obstacle_terms_lanes_factory(task)


def obstacle_terms_kernel_factory(task):
    """GN obstacle terms of a kinematic robot in an analytic primitive
    scene, through the CUDA terms kernel for CUDA tensors (None and
    NotImplementedError as ``_kernel_params``); a ``MultiRobot`` goes to
    ``multirobot_terms_kernel_factory``."""
    from ..robots.multi_robot import MultiRobot
    if isinstance(task.robot, MultiRobot):
        return multirobot_terms_kernel_factory(task)
    params = _kernel_params(task)
    if params is None:
        return None
    d, ints, floats, plain = params

    def terms(q_cols, lam, h=None):
        if q_cols.device.type == "cpu":
            return plain(q_cols, lam, h=h)
        return embed_terms(*run_terms_kernel(q_cols, ints, floats, d), lam,
                           h=h)

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        return run_terms_kernel(q_cols, ints, floats, d)

    terms.unscaled = unscaled
    terms.plain = plain
    terms.params = params
    return terms


def collision_cost_kernel_factory(task, terms=None):
    """Per-waypoint collision cost 0.5 sum r^2 (unscaled) of the same tasks
    as the terms, through the CUDA cost kernel for CUDA tensors (the
    value-only MultiRobot kernel for a ``MultiRobot``, with the
    NotImplementedError cases of ``multirobot_terms_kernel_factory``); the
    plain version is the cost output of the plain terms.  ``terms``, the
    task's hook from ``obstacle_terms_kernel_factory``, lends its packed
    parameters and plain terms, so they are built once per task."""
    from ..robots.multi_robot import MultiRobot
    if isinstance(task.robot, MultiRobot):
        return _multirobot_cost_factory(task, terms)
    params = (terms.params if hasattr(terms, "params")
              else _kernel_params(task))
    if params is None:
        return None
    d, ints, floats, plain_terms = params

    def plain(q_cols):
        return plain_terms.unscaled(q_cols)[2]

    def cost(q_cols):
        if q_cols.device.type == "cpu":
            return plain(q_cols)
        return run_cost_kernel(q_cols, ints, floats, d)

    cost.plain = plain
    return cost


def _mr_kernel_params(task):
    """(d, ints, floats, n_bp, plain terms) of a ``MultiRobot`` task for the
    mr_terms.cu kernels, or None unless every member has a kinematic model.
    A member with a learned self-collision net or grasped points, more than
    MR_MAX_MEMBERS members, more than MAX_DOF joints or 32 links in a
    member, and a same-member mutual pair raise NotImplementedError."""
    robot = task.robot
    members = robot.robots
    if not all(hasattr(r, "model") for r in members):
        return None
    for r in members:
        if getattr(r, "self_collision_net", None) is not None:
            raise NotImplementedError("the learned self-collision row is not "
                                      "in the CUDA MultiRobot terms kernel")
        if getattr(r, "grasped_n_points", 0) > 0 or r.object_interpolate:
            raise NotImplementedError("grasped-object or interpolated points "
                                      "are not in the CUDA MultiRobot terms "
                                      "kernel")
        if r.model.n_dofs > MAX_DOF or r.model.n_links > _MAX_LINKS:
            raise NotImplementedError(
                "the CUDA MultiRobot terms kernel takes at most %d joints and "
                "%d links per member" % (MAX_DOF, _MAX_LINKS))
    if len(members) > MR_MAX_MEMBERS:
        raise NotImplementedError("the CUDA MultiRobot terms kernel takes at "
                                  "most %d members" % MR_MAX_MEMBERS)
    plain = obstacle_terms_lanes_multirobot_factory(task)
    ints_np, floats_np = pack_multirobot_params(plain.layout)
    ints = torch.as_tensor(ints_np, device=task.device)
    floats = torch.as_tensor(floats_np, device=task.device)
    return robot.q_dim, ints, floats, int(ints_np[8]), plain


def multirobot_terms_kernel_factory(task):
    """GN obstacle terms of a ``MultiRobot`` task in an analytic primitive
    scene: the CUDA MultiRobot terms kernel for CUDA tensors, the plain
    block-structured terms for CPU tensors.  Same contract as
    ``obstacle_terms_kernel_factory``; None and NotImplementedError as
    ``_mr_kernel_params``."""
    params = _mr_kernel_params(task)
    if params is None:
        return None
    d, ints, floats, n_bp, plain = params
    shared = mr_shared_bytes(ints)

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        return run_multirobot_terms_kernel(q_cols, ints, floats, d, n_bp,
                                           shared)

    def terms(q_cols, lam, h=None):
        if q_cols.device.type == "cpu":
            return plain(q_cols, lam, h=h)
        return embed_terms(*unscaled(q_cols), lam, h=h)

    terms.unscaled = unscaled
    terms.plain = plain
    terms.params = params
    return terms


def _multirobot_cost_factory(task, terms=None):
    """Value-only cost of a ``MultiRobot`` task (see
    ``collision_cost_kernel_factory``)."""
    params = (terms.params if hasattr(terms, "params")
              else _mr_kernel_params(task))
    if params is None:
        return None
    d, ints, floats, n_bp, plain_terms = params
    shared = mr_shared_bytes(ints, cost_only=True)

    def plain(q_cols):
        return plain_terms.unscaled(q_cols)[2]

    def cost(q_cols):
        if q_cols.device.type == "cpu":
            return plain(q_cols)
        return run_multirobot_cost_kernel(q_cols, ints, floats, d, n_bp,
                                          shared)

    cost.plain = plain
    return cost
