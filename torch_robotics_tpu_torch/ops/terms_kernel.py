"""Fused GN obstacle-terms kernels and the value-only collision-cost
kernel: wrappers, parameter packing, dispatch.

Counterparts of torch_robotics_tpu/ops/pallas_terms.py
(``obstacle_terms_pallas_factory`` and ``collision_cost_pallas_factory``,
the TPU kernels they replace).  The CUDA source of the terms is
``csrc/terms.cu``, of the cost ``csrc/cost.cu``; each head comment says
what bounds the kernel on the H100 and how its design answers that.  The
plain PyTorch version of both is
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

A scene may hold precomputed SDF grids (``geom/grid_sdf.GridSDF``) beside
analytic objects: each grid is an object of the packed scene with no
primitive groups and a grid header (its first row in the scene's grid
table, its cmap_dim, its lower limits and float32 extent), and every grid
of a scene is one (C, 4) float32 device table (``scene_grid_table``) that
each launch takes as one more pointer.  The kernels look a cell up in it
themselves (``csrc/kin_scene.cuh::grid_sdf``), where the TPU kernel
gathered the cells' rows in an XLA stage before the kernel.

A robot that holds a grasped object has collision points fixed in the
frame of its grasped link beside the link origins: each kernel's packing
carries a point as (link, local offset), the offsets as a float section
and their count in the header, and the kernels place such a point at
R o + t of its link's world frame (``csrc/kin_scene.cuh::offset_point``).

A robot with a learned self-collision net has no pair rows in either
kernel's packed parameters; on a CUDA tensor its net row is added after
the terms kernel or the cost kernel by ``ops/net_kernel.py``'s kernels
(``csrc/net_row.cu``), in place into their unscaled outputs.

For a ``MultiRobot`` the terms come from ``multirobot_terms_kernel_factory``
with the same contract: its CUDA source is ``csrc/mr_terms.cu`` (which
replaces ``_multirobot_terms_pallas_factory``), its plain version
``ops/lanes_fk.obstacle_terms_lanes_multirobot_factory``.  The value-only
cost of a ``MultiRobot`` (the MultiRobot branch of
``collision_cost_pallas_factory``) is the same ``cost.cu`` kernel on the
members' packed parameters (``pack_cost_params``), with its own launch
counter, and its plain version the cost output of those plain terms.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaKernel
from .lanes_fk import (MultiRobotLayout, TermsLayout, embed_terms,
                       member_collision_points, obstacle_terms_lanes_factory,
                       obstacle_terms_lanes_multirobot_factory)
from .net_kernel import NetRowParams, add_net_cost, add_net_terms

__all__ = ["KERNEL", "COST_KERNEL", "MR_KERNEL", "MR_COST_KERNEL", "MAX_DOF",
           "MR_MAX_MEMBERS", "obstacle_terms_kernel_factory",
           "collision_cost_kernel_factory", "multirobot_terms_kernel_factory",
           "pack_terms_params", "pack_multirobot_params", "pack_cost_params",
           "cost_launch_config", "scene_grid_table", "run_terms_kernel",
           "run_cost_kernel",
           "run_multirobot_terms_kernel", "run_multirobot_cost_kernel"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("terms.cu", {
    "trt_terms_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                         _P, _P],
})
_COST_ARGS = {"trt_cost_launch": [_P, _P] + [ctypes.c_int] * 5
              + [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P]}
COST_KERNEL = CudaKernel("cost.cu", _COST_ARGS)
MR_KERNEL = CudaKernel("mr_terms.cu", {
    "trt_mr_terms_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _P, _P, _P, _P],
})
# the same kernel on a MultiRobot's parameters, counted apart
MR_COST_KERNEL = CudaKernel("cost.cu", _COST_ARGS)
MAX_DOF = 8        # terms.cu instantiates D = 1..8; mr_terms.cu kMaxDof
MR_MAX_MEMBERS = 4  # mr_terms.cu kMaxMembers
_MR_LANES = 32      # mr_terms.cu kLanes
_MAX_LINKS = 32    # terms.cu kMaxLinks
_COST_HEADER = 16         # cost.cu kHeader
_COST_MAX_THREADS = 256   # cost.cu kMaxThreads: lanes * threads a lane
_COST_LANES = 128         # lanes a block at one thread a lane
_COST_MAX_TPL = 8         # threads a lane, at most
_SMEM_MAX = 232448        # shared memory a block can have on the H100
_GROUP_KIND = {"Spheres": 0, "RoundedBoxes": 1, "SharpBoxes": 2}
_GRID_INTS, _GRID_FLOATS = 4, 8   # kin_scene.cuh grid_sdf's header


def _pack_scene(df_obj_list):
    """Scene objects -> (ints: object group ranges, group kinds, counts,
    offsets, each object's grid (-1 for an analytic object), the grids'
    headers (first row in ``scene_grid_table``, cmap_dim); floats: object
    rotations, positions, the grids' headers (lower limits, 0, float32
    extent, 0), primitive tables), the scene sections of the packed
    buffers.  A grid is an object with the identity pose and no groups."""
    from ..geom.grid_sdf import GridSDF
    from ..geom.sdf import ObjectField
    group_kind, group_count, group_off, obj_begin = [], [], [], [0]
    obj_rot, obj_pos, prims, obj_grid, grid_i, grid_f = [], [], [], [], [], []
    n_prims = n_rows = 0
    for obj in df_obj_list:
        if not isinstance(obj, (ObjectField, GridSDF)):
            raise NotImplementedError(
                "the CUDA terms kernels take ObjectField and GridSDF "
                "objects, not %s" % type(obj).__name__)
        if obj.dim != 3:
            raise NotImplementedError("the CUDA terms kernels take 3-D scenes")
        if isinstance(obj, GridSDF):
            lim = obj.limits.cpu().numpy().astype(np.float32)
            extent = np.abs(lim[1] - lim[0])         # float32, as the lookup
            obj_grid.append(len(grid_i))
            grid_i.append([n_rows] + list(obj.cmap_dim))
            grid_f.append(np.concatenate([lim[0], [0], extent, [0]]))
            n_rows += obj.n_cells
            obj_rot.append(np.eye(3).reshape(9))
            obj_pos.append(np.zeros(3))
            obj_begin.append(len(group_kind))
            continue
        obj_grid.append(-1)
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
    ints = [obj_begin, group_kind, group_count, group_off, obj_grid, grid_i]
    floats = [np.zeros(0) if not obj_rot else np.stack(obj_rot),
              np.zeros(0) if not obj_pos else np.stack(obj_pos),
              np.zeros(0) if not grid_f else np.stack(grid_f),
              np.zeros(0) if not prims else np.concatenate(prims)]
    return ints, floats


def scene_grid_table(df_obj_list):
    """Every grid of the scene as one (C, 4) float32 device table, rows in
    the order of ``_pack_scene``'s offsets (a single grid's own cached
    ``table()``), or None for a scene without grids."""
    from ..geom.grid_sdf import GridSDF
    tables = [obj.table() for obj in df_obj_list if isinstance(obj, GridSDF)]
    if not tables:
        return None
    return tables[0] if len(tables) == 1 else torch.cat(tables)


def _i32(sections):
    return np.concatenate([np.asarray(s, np.int64).reshape(-1)
                           for s in sections]).astype(np.int32)


def _f32(sections):
    return np.concatenate([np.asarray(s, np.float32).reshape(-1)
                           for s in sections])


def _offsets(lay) -> np.ndarray:
    """A TermsLayout's grasped points' offsets (G, 3) float32."""
    return np.asarray([o.cpu().numpy() for _, o in lay.extra],
                      np.float32).reshape(-1, 3)


def pack_terms_params(lay: TermsLayout):
    """Model + scene + collision rows -> (ints int32, floats float32), the
    two buffers ``terms.cu`` reads (section order as in its parse_layout).
    Of the P points the first P - G are link origins and the last G (the
    header's ninth int) grasped points, whose offsets in their link's frame
    are a float section of 3 G."""
    model = lay.model
    L = model.n_links
    ctrl = list(model.controlled_link_idxs())
    D = len(ctrl)
    anc = model.ancestry_matrix()
    q_idx = np.full(L, -1, np.int64)
    q_idx[ctrl] = np.arange(D)
    scene_i, scene_f = _pack_scene(lay.df_obj_list)

    header = [L, D, len(lay.point_links), len(lay.obj_pos), len(lay.pair_a),
              len(lay.df_obj_list), len(scene_i[1]), len(scene_i[5]),
              lay.n_grasped]
    anc_bits = [int(sum(1 << j for j in range(D) if anc[li, j]))
                for li in lay.point_links]
    ints = _i32([header, model.topological_order(), model.parent_idx,
                 model.joint_types, q_idx, ctrl, lay.point_links, anc_bits,
                 lay.obj_pos, lay.pair_a, lay.pair_b] + scene_i)
    floats = _f32([model.joint_trans, model.joint_fixed_rot, model.joint_axis,
                   model.clamp_lower, model.clamp_upper,
                   lay.obj_thresh.cpu().numpy(),
                   lay.self_margins.cpu().numpy(), lay.ws_min.cpu().numpy(),
                   lay.ws_max.cpu().numpy(), _offsets(lay)] + scene_f)
    return ints, floats


def _member_points(r, section):
    """(link, offset (3,) float32 or None) of each point of a member's
    section (``member_collision_points``)."""
    gp = (r.grasped_points.cpu().numpy().astype(np.float32)
          if getattr(r, "grasped_n_points", 0) else None)
    return [(li, None if g < 0 else gp[g])
            for li, g in member_collision_points(r, section)]


def pack_multirobot_params(lay: MultiRobotLayout):
    """Members' models + base poses + row groups + scene -> (ints int32,
    floats float32), the two buffers ``mr_terms.cu`` reads (section order as
    in its parse_layout).  A grasped point has its offset's index in
    ``pt_goff`` (-1 for a link origin), the offsets a float section of 3 per
    grasped point (their count ints[11]).  Block pairs: the n diagonal
    blocks, then the cross blocks (i, j), i < j, in order; each cross
    block's mutual rows are stored with their first point on member i (a
    pair listed the other way round is swapped, which leaves its row
    unchanged)."""
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
    pt_member, pt_link, pt_anc, pt_goff, goff = [], [], [], [], []
    for section in ("object", "self"):
        for i, (r, m) in enumerate(zip(members, models)):
            anc = m.ancestry_matrix()
            for li, off in _member_points(r, section):
                pt_member.append(i)
                pt_link.append(li)
                pt_anc.append(int(sum(1 << j for j in range(m.n_dofs)
                                      if anc[li, j])))
                pt_goff.append(-1 if off is None else len(goff))
                if off is not None:
                    goff.append(off)
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
              int(l_off[-1]), len(scene_i[5]), len(goff)] + [0] * 4
    ints = _i32([header, L_list, lay.d_list, lay.d_off[:-1], l_off[:-1],
                 obj_off[:-1], obj_off[1:],
                 [b for b, _ in own_range], [e for _, e in own_range],
                 [i for i, _ in bp], [j for _, j in bp],
                 [b for b, _ in bp_range], [e for _, e in bp_range],
                 topo, parent, jtype, qidx, ctrl, pt_member, pt_link, pt_anc,
                 pt_goff, own_a, own_b, mut_a, mut_b] + scene_i)
    floats = _f32(
        [np.concatenate([m.joint_trans.reshape(-1) for m in models]),
         np.concatenate([m.joint_fixed_rot.reshape(-1) for m in models]),
         np.concatenate([m.joint_axis.reshape(-1) for m in models]),
         np.concatenate([m.clamp_lower for m in models]),
         np.concatenate([m.clamp_upper for m in models]),
         robot.base_rots.cpu().numpy(), robot.base_trans.cpu().numpy(),
         lay.obj_thresh.cpu().numpy(), own_m, mut_m,
         lay.ws_min.cpu().numpy(), lay.ws_max.cpu().numpy(),
         np.zeros((0, 3)) if not goff else np.stack(goff)] + scene_f)
    return ints, floats


def mr_shared_bytes(ints, cost_only: bool = False) -> int:
    """Dynamic shared memory of one mr_terms.cu block: points, joint axes
    and origins (3 floats each, per lane) and the per-warp cost shares;
    with ``cost_only``, the points and the shares alone."""
    P, D, n_bp = int(ints[2]), int(ints[1]), int(ints[8])
    return 4 * _MR_LANES * (3 * P + (0 if cost_only else 6 * D) + n_bp)


def _cost_members(lay):
    """[(model, base R (3, 3), base t (3,), [(point, link, offset (3,) or
    None), ...]), ...]: a ``TermsLayout`` is one member at the identity
    base with its used links' origins and its grasped points as points; a
    ``MultiRobotLayout`` has its members at their base poses, points
    numbered over the full collision layout (object sections, then self
    sections, member by member)."""
    if not isinstance(lay, MultiRobotLayout):
        offs = _offsets(lay)
        n_used = len(lay.used_links)
        return [(lay.model, np.eye(3), np.zeros(3),
                 [(p, li, None if p < n_used else offs[p - n_used])
                  for p, li in enumerate(lay.point_links)])]
    points = [[] for _ in lay.members]
    p = 0
    for section in ("object", "self"):
        for i, r in enumerate(lay.members):
            for li, off in _member_points(r, section):
                points[i].append((p, li, off))
                p += 1
    base_R = lay.robot.base_rots.cpu().numpy().reshape(-1, 3, 3)
    base_t = lay.robot.base_trans.cpu().numpy().reshape(-1, 3)
    return [(r.model, base_R[i], base_t[i], points[i])
            for i, r in enumerate(lay.members)]


def _fk_steps(model, links):
    """The links that lead to a collision link, in topological order, and
    the links whose transform a later step reads while not right before
    it (a branching tree; empty for a chain)."""
    need = set()
    for li in links:
        while li >= 0 and li not in need:
            need.add(li)
            li = model.parent_idx[li]
    steps = [i for i in model.topological_order() if i in need]
    parents = [model.parent_idx[i] for i in steps]
    stored = {p for k, p in enumerate(parents)
              if p >= 0 and (k == 0 or steps[k - 1] != p)}
    return steps, stored


def cost_row_ops(lay) -> np.ndarray:
    """Float ops of each cost row in the kernel's row order (one object SDF
    row per object point when the scene has objects or grids, one
    workspace row per object point, one per pair): 15 per object and 10 /
    25 / 12 per sphere / rounded box / sharp box, or 22 per grid (the cell
    index and its clamp), for an SDF row, 12 for a workspace row or a pair
    distance, and 4 for the hinge, its square and the sum."""
    from ..geom.grid_sdf import GridSDF
    from ..geom.sdf import RoundedBoxes, Spheres
    sdf = 0
    for obj in lay.df_obj_list:
        if isinstance(obj, GridSDF):
            sdf += 22
            continue
        sdf += 15
        for f in obj.fields:
            sdf += f.centers.shape[0] * (10 if isinstance(f, Spheres) else (
                25 if isinstance(f, RoundedBoxes) else 12))
    n_obj, n_pair = len(lay.obj_pos), len(lay.pair_a)
    return np.asarray(([sdf + 4] * n_obj if lay.df_obj_list else [])
                      + [16] * (n_obj + n_pair), np.int64)


def _row_cuts(ops: np.ndarray, T: int) -> list:
    """T contiguous row ranges of near-equal operation counts: cut t is the
    row boundary nearest to t / T of the total."""
    c = np.concatenate([[0], np.cumsum(ops)])
    return [int(np.argmin(np.abs(c - c[-1] * t / T))) for t in range(T + 1)]


def pack_cost_params(lay):
    """A ``TermsLayout`` or ``MultiRobotLayout`` -> (ints int32, floats
    float32), the two buffers ``cost.cu`` reads (section order as in its
    parse_layout).  What a step or an object reads together is one record
    on a 16-byte boundary, read with 16-byte loads: a step's 8 ints (joint
    type, q column, parent source, slot, its points' range, how many of
    them, the last ones, are offset points and their first offset record)
    and 20 floats (fixed rotation, translation, axis, clamp bounds, 3 pad);
    an offset point's 4 floats (offset, 0) (a grasped point; their count
    ints[12]); an object's 12 floats (rotation, position); a grid's header,
    8 floats (lower limits, extent, each padded to 4); each primitive
    group's table, padded to a multiple of 4 floats (a sphere is one
    load).  A sphere
    group whose radii are all equal gets kind 3, which the kernel scores
    with one square root.

    Each member's FK is a list of steps (``_fk_steps``): a step's parent
    transform is the member's base (src -1), the previous step's (-2, kept
    in registers) or a stored slot; a step stores its own when a later,
    non-adjacent step reads it, and writes the world position of the
    collision points on its link (its origin, or R o + t for an offset
    point).  The rows are cut into T ranges, one per
    thread of a lane, balanced by ``cost_row_ops``: T = 1 for a single
    robot; for a MultiRobot at least the member count (phase 1 runs one FK
    chain a thread), and enough threads that a range takes about as many
    operations as the longest chain, at most 8."""
    members = _cost_members(lay)
    mem_step, step_i, step_f, pt_list, fk_ops = [0], [], [], [], []
    offsets = []
    n_slots, doff = 0, 0
    for model, _, _, points in members:
        steps, stored = _fk_steps(model, [li for _, li, _ in points])
        ctrl = list(model.controlled_link_idxs())
        slot_of, prev = {}, None
        for i in steps:
            p = model.parent_idx[i]
            src = -1 if p < 0 else (-2 if p == prev else slot_of[p])
            if i in stored:
                slot_of[i] = n_slots
                n_slots += 1
            begin, obegin = len(pt_list), len(offsets)
            pt_list += sorted(pt for pt, li, o in points
                              if li == i and o is None)
            on_link = sorted((pt, o) for pt, li, o in points
                             if li == i and o is not None)
            pt_list += [pt for pt, _ in on_link]
            offsets += [np.append(o, 0.0) for _, o in on_link]
            step_i.append([model.joint_types[i],
                           doff + ctrl.index(i) if i in ctrl else -1, src,
                           slot_of.get(i, -1), begin, len(pt_list),
                           len(on_link), obegin if on_link else 0])
            step_f.append(np.concatenate([
                model.joint_fixed_rot[i].reshape(9), model.joint_trans[i],
                model.joint_axis[i],
                [model.clamp_lower[i], model.clamp_upper[i], 0, 0, 0]]))
            prev = i
        mem_step.append(len(step_i))
        fk_ops.append(sum(63 if model.joint_types[i] == 0 else 132
                          for i in steps)
                      + 18 * sum(o is not None for _, _, o in points))
        doff += model.n_dofs

    ops = cost_row_ops(lay)
    T = 1 if len(members) == 1 else int(min(_COST_MAX_TPL, max(
        len(members), -(-int(ops.sum()) // max(fk_ops)))))
    scene_i, (obj_rot, obj_pos, grid_f, prims) = _pack_scene(
        lay.df_obj_list)
    width = {0: 4, 1: 7, 2: 6}
    tables, off, kinds = [], [], []
    for kind, cnt, o in zip(*scene_i[1:4]):
        off.append(sum(len(t) for t in tables))
        t = prims[o:o + width[kind] * cnt]
        tables.append(np.concatenate([t, np.zeros(-len(t) % 4)]))
        # spheres of one radius: cost.cuh's kSpheresOneRadius
        kinds.append(3 if kind == 0 and len(set(t[3::4])) == 1 else kind)
    scene_i[1], scene_i[3] = kinds, off
    objects = np.concatenate([np.asarray(obj_rot).reshape(-1, 9),
                              np.asarray(obj_pos).reshape(-1, 3)], axis=1)
    header = [len(members), doff, len(pt_list), len(lay.obj_pos),
              len(lay.pair_a), len(lay.df_obj_list), len(scene_i[1]),
              len(step_i), n_slots, T, sum(len(t) for t in tables),
              len(scene_i[5]), len(offsets)]
    header += [0] * (_COST_HEADER - len(header))
    ints = _i32([header, step_i, mem_step, pt_list, lay.obj_pos, lay.pair_a,
                 lay.pair_b, _row_cuts(ops, T)] + scene_i)
    floats = _f32(tables + [objects, grid_f, step_f, offsets]
                  + [np.stack([R for _, R, _, _ in members]),
                     np.stack([t for _, _, t, _ in members]),
                     lay.obj_thresh.cpu().numpy(),
                     lay.self_margins.cpu().numpy(),
                     lay.ws_min.cpu().numpy(), lay.ws_max.cpu().numpy()])
    return ints, floats


def cost_launch_config(ints, n_floats: int, lanes=None) -> dict:
    """Launch shape of ``cost.cu`` from its packed header: the T threads a
    lane that ``pack_cost_params`` scheduled, the lanes a block (128 at one
    thread a lane, else the whole warps of lanes that keep a block within
    256 threads, or ``lanes``), the dynamic shared memory in bytes (the
    parameters, and per lane its q, points, stored transforms and T
    partial sums).  NotImplementedError where 32 lanes pass the H100's
    232,448 bytes."""
    D, P, n_slots, T = (int(ints[i]) for i in (1, 2, 8, 9))
    if lanes is None:
        lanes = _COST_LANES if T == 1 else 32 * max(
            1, _COST_MAX_THREADS // (32 * T))
    fixed = 4 * (-(-len(ints) // 4) * 4 + -(-n_floats // 4) * 4)
    per_lane = 4 * (D + 3 * P + 12 * n_slots + T)
    while lanes > 32 and fixed + lanes * per_lane > _SMEM_MAX:
        lanes -= 32
    smem = fixed + lanes * per_lane
    if smem > _SMEM_MAX or lanes * T > _COST_MAX_THREADS:
        raise NotImplementedError(
            "the CUDA cost kernel's block needs %d bytes of shared memory "
            "and %d threads (at most %d and %d)"
            % (smem, lanes * T, _SMEM_MAX, _COST_MAX_THREADS))
    return dict(lanes=lanes, threads_per_lane=T, threads=lanes * T,
                smem_bytes=smem)


def _check_q(q_cols, ints, floats, d: int):
    if q_cols.device.type != "cuda":
        raise ValueError("the terms and cost kernels take CUDA tensors")
    if q_cols.dtype != torch.float32 or not q_cols.is_contiguous():
        raise ValueError("q_cols must be contiguous float32")
    if q_cols.dim() != 2 or q_cols.shape[0] != d:
        raise ValueError("q_cols must be (%d, N), got %s"
                         % (d, tuple(q_cols.shape)))
    if ints.device != q_cols.device or floats.device != q_cols.device:
        raise ValueError("the task's kernel parameters live on %s, q_cols "
                         "on %s" % (ints.device, q_cols.device))


def _grid_ptr(grid, q_cols):
    """The device address of a scene's grid table (``scene_grid_table``:
    (C, 4) float32, contiguous, on q's device), or None without one."""
    if grid is None:
        return None
    if (grid.device != q_cols.device or grid.dtype != torch.float32
            or grid.dim() != 2 or grid.shape[1] != 4
            or not grid.is_contiguous()):
        raise ValueError("the grid table must be a contiguous (C, 4) float32 "
                         "tensor on %s, got %s %s on %s" % (
                             q_cols.device, tuple(grid.shape), grid.dtype,
                             grid.device))
    return grid.data_ptr()


def run_terms_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                     floats: torch.Tensor, d: int, grid=None):
    """Launch the CUDA terms kernel: q_cols (d, N) float32 contiguous CUDA
    -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,)); ``grid`` the
    scene's grid table when it has grids."""
    _check_q(q_cols, ints, floats, d)
    grid_ptr = _grid_ptr(grid, q_cols)
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
                      floats.data_ptr(), grid_ptr, stream)
    return g, Hqq, cost


def _launch_cost(kernel, q_cols, ints, floats, d, launch, lanes, grid):
    _check_q(q_cols, ints, floats, d)
    grid_ptr = _grid_ptr(grid, q_cols)
    if launch is None or lanes is not None:
        launch = cost_launch_config(ints.cpu().numpy(), floats.numel(), lanes)
    N = q_cols.shape[1]
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel.launch("trt_cost_launch", q_cols.data_ptr(), cost.data_ptr(),
                      N, d, launch["lanes"], launch["threads_per_lane"],
                      launch["smem_bytes"], ints.data_ptr(), ints.numel(),
                      floats.data_ptr(), floats.numel(), grid_ptr, stream)
    return cost


def run_cost_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                    floats: torch.Tensor, d: int, launch=None, lanes=None,
                    grid=None):
    """Launch the CUDA value-only cost kernel on a single robot's packed
    parameters (``pack_cost_params``): q_cols (d, N) float32 contiguous CUDA
    -> unscaled cost (N,).  ``launch`` is ``cost_launch_config``'s shape
    (read from a host copy of ``ints`` when None); ``lanes`` launches at
    another lane count a block; ``grid`` the scene's grid table."""
    return _launch_cost(COST_KERNEL, q_cols, ints, floats, d, launch, lanes,
                        grid)


def run_multirobot_terms_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                                floats: torch.Tensor, d: int, n_bp: int,
                                shared_bytes: int, grid=None):
    """Launch the CUDA MultiRobot terms kernel: q_cols (d, N) float32
    contiguous CUDA -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,));
    ``grid`` the scene's grid table."""
    _check_q(q_cols, ints, floats, d)
    grid_ptr = _grid_ptr(grid, q_cols)
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
                         floats.data_ptr(), grid_ptr, stream)
    return g, Hqq, cost


def run_multirobot_cost_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                               floats: torch.Tensor, d: int, launch=None,
                               lanes=None, grid=None):
    """``run_cost_kernel`` on a MultiRobot's packed parameters, counted on
    ``MR_COST_KERNEL``."""
    return _launch_cost(MR_COST_KERNEL, q_cols, ints, floats, d, launch,
                        lanes, grid)


def _kernel_params(task):
    """(d, ints, floats, plain terms) of a task the terms.cu kernels take,
    or None where the reference's fused factories return None (a point
    mass, robots without a kinematic model, interpolated collision points).
    A 2-D scene raises NotImplementedError.  A robot with a learned
    self-collision net packs no pair rows (its net row runs in
    ``csrc/net_row.cu``)."""
    from ..robots.point_mass import RobotPointMass
    robot = task.robot
    if isinstance(robot, RobotPointMass):
        return None
    if not hasattr(robot, "model") or robot.object_interpolate:
        return None
    plain = obstacle_terms_lanes_factory(task)
    lay = plain.layout
    d = lay.model.n_dofs
    if d > MAX_DOF or lay.model.n_links > _MAX_LINKS:
        raise NotImplementedError(
            "the CUDA terms kernel takes at most %d joints and %d links"
            % (MAX_DOF, _MAX_LINKS))
    ints_np, floats_np = pack_terms_params(lay)
    ints = torch.as_tensor(ints_np, device=task.device)
    floats = torch.as_tensor(floats_np, device=task.device)
    return d, ints, floats, plain


def obstacle_terms_kernel_factory(task):
    """GN obstacle terms of a kinematic robot in an analytic primitive
    scene, through the CUDA terms kernel for CUDA tensors, followed by the
    net row kernel for a robot with a learned self-collision net (None and
    NotImplementedError as ``_kernel_params``); a ``MultiRobot`` goes to
    ``multirobot_terms_kernel_factory``."""
    from ..robots.multi_robot import MultiRobot
    if isinstance(task.robot, MultiRobot):
        return multirobot_terms_kernel_factory(task)
    params = _kernel_params(task)
    if params is None:
        return None
    d, ints, floats, plain = params
    lay = plain.layout
    net_row = (None if lay.net is None
               else NetRowParams(lay.net, lay.net_cutoff, task.device))
    grid = scene_grid_table(lay.df_obj_list)

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        out = run_terms_kernel(q_cols, ints, floats, d, grid)
        if net_row is not None:
            add_net_terms(net_row, q_cols, *out)
        return out

    def terms(q_cols, lam, h=None):
        if q_cols.device.type == "cpu":
            return plain(q_cols, lam, h=h)
        return embed_terms(*unscaled(q_cols), lam, h=h)

    terms.unscaled = unscaled
    terms.plain = plain
    terms.params = params
    terms.net_row = net_row
    terms.grid = grid
    return terms


def collision_cost_kernel_factory(task, terms=None):
    """Per-waypoint collision cost 0.5 sum r^2 (unscaled) of the same tasks
    as the terms, through the CUDA cost kernel (``cost.cu``) for CUDA
    tensors, followed by the value-only net row kernel for a robot with a
    learned self-collision net (on the members' parameters for a
    ``MultiRobot``, with the
    NotImplementedError cases of ``multirobot_terms_kernel_factory``); the
    plain version is the cost output of the plain terms.  ``terms``, the
    task's hook from ``obstacle_terms_kernel_factory``, lends its plain
    terms, their layout and its net row, so they are built once per task
    (without it, the hook is built here)."""
    from ..robots.multi_robot import MultiRobot
    if isinstance(task.robot, MultiRobot):
        return _multirobot_cost_factory(task, terms)
    if not hasattr(terms, "params"):
        terms = obstacle_terms_kernel_factory(task)
        if terms is None:
            return None
    d, _, _, plain_terms = terms.params
    net_row = terms.net_row
    run = run_cost_kernel
    if net_row is not None:
        def run(q_cols, ints, floats, d, launch, grid):
            cost = run_cost_kernel(q_cols, ints, floats, d, launch,
                                   grid=grid)
            add_net_cost(net_row, q_cols, cost)
            return cost
    return _cost_fn(pack_cost_params(plain_terms.layout), task.device, d,
                    plain_terms, run, terms.grid)


def _cost_fn(packed, device, d, plain_terms, run, grid):
    """cost(q_cols) on the packed cost parameters: the kernel through
    ``run`` for a CUDA tensor (with the scene's grid table ``grid``), the
    plain terms' cost for a CPU tensor."""
    ints_np, floats_np = packed
    launch = cost_launch_config(ints_np, len(floats_np))
    ints = torch.as_tensor(ints_np, device=device)
    floats = torch.as_tensor(floats_np, device=device)

    def plain(q_cols):
        return plain_terms.unscaled(q_cols)[2]

    def cost(q_cols):
        if q_cols.device.type == "cpu":
            return plain(q_cols)
        return run(q_cols, ints, floats, d, launch, grid=grid)

    cost.plain = plain
    cost.params = (d, ints, floats, launch)
    cost.grid = grid
    return cost


def _mr_kernel_params(task):
    """(d, ints, floats, n_bp, plain terms) of a ``MultiRobot`` task for the
    mr_terms.cu kernels, or None unless every member has a kinematic model.
    A member with a learned self-collision net or interpolated points,
    more than MR_MAX_MEMBERS members, more than MAX_DOF joints or 32 links
    in a member, and a same-member mutual pair raise NotImplementedError."""
    robot = task.robot
    members = robot.robots
    if not all(hasattr(r, "model") for r in members):
        return None
    for r in members:
        if getattr(r, "self_collision_net", None) is not None:
            raise NotImplementedError("the learned self-collision row is not "
                                      "in the CUDA MultiRobot terms kernel")
        if r.object_interpolate:
            raise NotImplementedError("interpolated points are not in the "
                                      "CUDA MultiRobot terms kernel")
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
    grid = scene_grid_table(plain.layout.df_obj_list)

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        return run_multirobot_terms_kernel(q_cols, ints, floats, d, n_bp,
                                           shared, grid)

    def terms(q_cols, lam, h=None):
        if q_cols.device.type == "cpu":
            return plain(q_cols, lam, h=h)
        return embed_terms(*unscaled(q_cols), lam, h=h)

    terms.unscaled = unscaled
    terms.plain = plain
    terms.params = params
    terms.grid = grid
    return terms


def _multirobot_cost_factory(task, terms=None):
    """Value-only cost of a ``MultiRobot`` task (see
    ``collision_cost_kernel_factory``)."""
    params = (terms.params if hasattr(terms, "params")
              else _mr_kernel_params(task))
    if params is None:
        return None
    d, _, _, _, plain_terms = params
    return _cost_fn(pack_cost_params(plain_terms.layout), task.device, d,
                    plain_terms, run_multirobot_cost_kernel,
                    scene_grid_table(plain_terms.layout.df_obj_list))
