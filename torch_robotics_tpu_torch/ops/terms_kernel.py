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
version; a CUDA tensor launches the kernel or raises.  The terms kernel
reads the cost kernel's packing of the same layout with each point's
joint mask after it (``pack_terms_params``), staged in shared memory, at
the lanes a block of ``terms_launch_config``.

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
``ops/lanes_fk.obstacle_terms_lanes_multirobot_factory``; the kernel reads
the members' cost packing with the terms' sections after it
(``pack_multirobot_params``) at the launch shape of
``mr_terms_launch_config`` (a warp a block pair, members past 8 joints
with their block sums in shared memory).  The value-only cost of a
``MultiRobot`` (the MultiRobot branch of ``collision_cost_pallas_factory``)
is the same
``cost.cu`` kernel on the members' packed parameters
(``pack_cost_kernel_params``), with its own launch counter, and its plain
version the cost output of those plain terms.

A MultiRobot takes the MultiRobot kernels with any member the reference
plans for: a member with a learned self-collision net (whose net neither
package's MultiRobot rows read: its own pair rows stay, as the reference's
XLA MultiRobot terms and residuals keep them), a member past eight joints
(K5's route with its sums in shared memory), up to eight members, and a
mutual pair between two object points of one member (on that member's
diagonal block; its plain version is the generic padded assembly).

A task past a kernel's caps keeps its plain terms or cost on the CPU, as
the reference's fused factories return None there, and raises
NotImplementedError, in the kernel's words, when a CUDA tensor reaches the
kernel: nothing falls back to the plain version on the card.  The terms
kernels' caps (``_refusal``): a scene object they do not take, a 2-D
scene, a primitive group past what their pick of the nearest primitive
indexes, more than ``MAX_DOF`` joints for a single robot (terms.cu:
``terms_kernel<D>`` up to 8 joints, ``terms_wide_kernel`` up to 32), or
for a MultiRobot more than ``MR_MAX_MEMBERS`` members, a member past
``MR_MAX_DOF`` joints or with interpolated points; or a block past the
H100's shared memory.  The cost kernel has its own (``_cost_refusal``):
the scene, more than ``COST_MAX_MEMBERS`` members or ``COST_MAX_DOF``
joints, a MultiRobot member with interpolated points (as the reference's
cost factory); or its block.  So a single robot past the terms kernel's
joints keeps the cost kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaKernel
from .lanes_fk import (MultiRobotLayout, TermsLayout, embed_terms,
                       member_collision_points, obstacle_terms_lanes_factory)
from .net_kernel import NetRowParams, add_net_cost, add_net_terms

__all__ = ["KERNEL", "COST_KERNEL", "MR_KERNEL", "MR_COST_KERNEL", "MAX_DOF",
           "MR_MAX_DOF", "MR_MAX_MEMBERS", "COST_MAX_DOF", "COST_MAX_MEMBERS",
           "obstacle_terms_kernel_factory",
           "collision_cost_kernel_factory", "multirobot_terms_kernel_factory",
           "pack_terms_params", "pack_multirobot_params", "pack_cost_params",
           "pack_cost_kernel_params",
           "cost_launch_config", "terms_launch_config",
           "mr_terms_launch_config", "scene_grid_table",
           "run_terms_kernel",
           "run_cost_kernel",
           "run_multirobot_terms_kernel", "run_multirobot_cost_kernel"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("terms.cu", {
    "trt_terms_launch": [_P] * 4 + [ctypes.c_int] * 4
    + [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P],
})
_COST_ARGS = {"trt_cost_launch": [_P, _P] + [ctypes.c_int] * 5
              + [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P]}
COST_KERNEL = CudaKernel("cost.cu", _COST_ARGS)
MR_KERNEL = CudaKernel("mr_terms.cu", {
    "trt_mr_terms_launch": [_P] * 4 + [ctypes.c_int] * 6
    + [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P],
})
# the same kernel on a MultiRobot's parameters, counted apart
MR_COST_KERNEL = CudaKernel("cost.cu", _COST_ARGS)
# terms.cu: terms_kernel<D> for D = 1..8, terms_wide_kernel<16, 24, 32>
# for D = 9..32 (a point's joint mask is 32 bits)
MAX_DOF = 32
_WIDE_DOF = 9       # the first joint count of terms_wide_kernel
# mr_terms.cu: mr_terms_kernel<8> keeps a member's accumulators in
# registers, mr_terms_kernel<16, 24, 32> its block sums in shared memory (a
# point's joint mask is 32 bits over its member's columns); a warp walks
# block pairs, so the members are K8's cap (COST_MAX_MEMBERS)
MR_MAX_DOF = 32
_MR_NARROW_DOF = 8        # mr_terms.cu kNarrowDof
MR_MAX_MEMBERS = 8
_MR_LANES = 32            # lanes a block of mr_terms.cu, a warp of them
_MR_MAX_THREADS = 320     # mr_terms.cu kMaxThreads (the register route)
_MR_WIDE_MAX_THREADS = 256   # mr_terms.cu kWideMaxThreads
_MR_EXTRAS = 13           # the cost header's int that locates K5's sections
_TERMS_LANES = 128        # terms.cu kMaxLanes: lanes (threads) a block
_COST_HEADER = 16         # cost.cu kHeader
_COST_MAX_THREADS = 256   # cost.cu kMaxThreads: lanes * threads a lane
_COST_LANES = 128         # lanes a block at one thread a lane
_COST_LANE_COUNTS = (32, 64, 96, 128)   # cost.cu's cost_kernel<kLanes>
_COST_MAX_TPL = 8         # threads a lane, at most
_COST_MAX_Q = 8           # cost.cu kMaxQ: q columns a thread stages
# cost.cu: phase 1 runs one member's FK chain a thread (at most
# _COST_MAX_TPL threads a lane), and the block stages at most kMaxQ q
# columns a thread
COST_MAX_MEMBERS = _COST_MAX_TPL
COST_MAX_DOF = _COST_MAX_Q * _COST_MAX_TPL
# the words in which the MultiRobot kernels (K5, and K8 as the reference's
# cost factory) refuse a member
_MR_INTERP_WORDS = ("the CUDA MultiRobot kernels take no member with "
                    "interpolated points")
_SMEM_MAX = 232448        # shared memory a block can have on the H100
_SMEM_SM = 233472         # shared memory of an H100 SM, 1 KB of it reserved
_SMEM_BLOCK_RESERVED = 1024   # a block
# warps an SM holds of terms_wide_kernel: ptxas gives it 245-255
# registers a thread, 8 warps of 32 x 256 in the SM's 65,536
_WIDE_MAX_WARPS = 8
_GROUP_KIND = {"Spheres": 0, "RoundedBoxes": 1, "SharpBoxes": 2}
_GRID_INTS, _GRID_FLOATS = 4, 8   # kin_scene.cuh grid_sdf's header


def _scene_refusal(df_obj_list):
    """The words in which every CUDA terms and cost kernel refuses a scene,
    or None where they take it: an object other than an ObjectField or a
    GridSDF, a 2-D scene, or more primitive groups or primitives in a
    group than the terms kernels' pick of the nearest primitive holds
    (cost.cuh: scene_sdf_pick packs it as group << 16 | index)."""
    from ..geom.grid_sdf import GridSDF
    from ..geom.sdf import ObjectField
    for obj in df_obj_list:
        if not isinstance(obj, (ObjectField, GridSDF)):
            return ("the CUDA terms kernels take ObjectField and GridSDF "
                    "objects, not %s" % type(obj).__name__)
        if obj.dim != 3:
            return "the CUDA terms kernels take 3-D scenes"
    groups = [f for obj in df_obj_list for f in getattr(obj, "fields", ())]
    if len(groups) > 1 << 15 or any(f.centers.shape[0] > 1 << 16
                                    for f in groups):
        return ("the CUDA terms kernels take at most 32,768 primitive "
                "groups of at most 65,536 primitives")
    return None


def _pack_scene(df_obj_list):
    """Scene objects -> (ints: object group ranges, group kinds, counts,
    offsets, each object's grid (-1 for an analytic object), the grids'
    headers (first row in ``scene_grid_table``, cmap_dim); floats: object
    rotations, positions, the grids' headers (lower limits, 0, float32
    extent, 0), primitive tables), the scene sections of the packed
    buffers.  A grid is an object with the identity pose and no groups."""
    from ..geom.grid_sdf import GridSDF
    refusal = _scene_refusal(df_obj_list)
    if refusal is not None:
        raise NotImplementedError(refusal)
    group_kind, group_count, group_off, obj_begin = [], [], [], [0]
    obj_rot, obj_pos, prims, obj_grid, grid_i, grid_f = [], [], [], [], [], []
    n_prims = n_rows = 0
    for obj in df_obj_list:
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
    two buffers ``terms.cu`` reads (section order as in its parse_layout):
    ``pack_cost_params``' buffers of the layout (its FK steps, points,
    rows and scene records), then an int section of P bit masks, bit j of
    point p set when joint j moves p's link (a grasped point's is its
    link's)."""
    ints, floats = pack_cost_params(lay)
    anc = lay.model.ancestry_matrix()[lay.point_links]        # (P, D)
    masks = [int(sum(1 << j for j in np.flatnonzero(row))) for row in anc]
    # bit 31 (joint 31) is the int32's sign
    masks = [m - (1 << 32) * (m >> 31) for m in masks]
    return _i32([ints, masks]), floats


def _fit_block(what, ints, n_floats, per_lane, lanes, threads_per_lane,
               max_threads):
    """(lanes, dynamic shared memory in bytes, refusal): ``lanes`` lanes a
    block, whole warps fewer while the block passes the H100's 232,448
    bytes (the packed parameters, rounded to 16 bytes each, and
    ``per_lane`` bytes a lane); the refusal, the words a launch shape
    raises with, where 32 lanes do not fit or the block passes
    ``max_threads`` threads, else None."""
    fixed = 4 * (-(-len(ints) // 4) * 4 + -(-n_floats // 4) * 4)
    while lanes > 32 and fixed + lanes * per_lane > _SMEM_MAX:
        lanes -= 32
    smem = fixed + lanes * per_lane
    threads = lanes * threads_per_lane
    if smem > _SMEM_MAX or not 1 <= threads <= max_threads:
        return lanes, smem, (
            "the CUDA %s kernel's block needs %d bytes of shared memory and "
            "%d threads (at most %d and %d)"
            % (what, smem, threads, _SMEM_MAX, max_threads))
    return lanes, smem, None


def _wide_lanes(ints, n_floats: int, per_lane: int) -> int:
    """The lanes a block of terms_wide_kernel that keep the most warps
    resident on an SM (its shared memory and _WIDE_MAX_WARPS), the most
    lanes among equals: one block of 128 lanes at ~1 KB a lane holds 4
    warps an SM, three of 64 hold 6."""
    fixed = 4 * (-(-len(ints) // 4) * 4 + -(-n_floats // 4) * 4)

    def warps(lanes):
        smem = fixed + lanes * per_lane
        if smem > _SMEM_MAX:
            return 0
        blocks = _SMEM_SM // (smem + _SMEM_BLOCK_RESERVED)
        return min(_WIDE_MAX_WARPS, blocks * lanes // 32)
    return max((128, 96, 64, 32), key=lambda n: (warps(n), n))


def _terms_block(ints, n_floats: int, lanes=None):
    """``terms_launch_config``'s shape and refusal (``_fit_block``)."""
    D, P, n_slots = int(ints[1]), int(ints[2]), int(ints[8])
    per_lane = 4 * (7 * D + 3 * P + 12 * n_slots)
    if D >= _WIDE_DOF:
        # terms_wide_kernel keeps Hqq's packed triangle in shared memory
        per_lane += 4 * (D * (D + 1) // 2)
        if lanes is None:
            lanes = _wide_lanes(ints, n_floats, per_lane)
    lanes, smem, refusal = _fit_block(
        "terms", ints, n_floats, per_lane,
        _TERMS_LANES if lanes is None else lanes, 1, _TERMS_LANES)
    return dict(lanes=lanes, smem_bytes=smem), refusal


def terms_launch_config(ints, n_floats: int, lanes=None) -> dict:
    """Launch shape of ``terms.cu`` from its packed header: ``lanes`` lanes
    (one thread each) a block, 128 unless given (whole warps fewer while
    the block passes the H100's 232,448 bytes; past 8 joints the count
    that keeps the most warps an SM, ``_wide_lanes``), and the dynamic
    shared memory in bytes: the parameters, and per lane its q, joint
    axes and origins (6 D), points (3 P), stored transforms and, past 8
    joints, Hqq's packed triangle (D (D + 1) / 2).  NotImplementedError
    where 32 lanes do not fit."""
    launch, refusal = _terms_block(ints, n_floats, lanes)
    if refusal is not None:
        raise NotImplementedError(refusal)
    return launch


def _member_points(r, section):
    """(link, offset (3,) float32 or None) of each point of a member's
    section (``member_collision_points``)."""
    gp = (r.grasped_points.cpu().numpy().astype(np.float32)
          if getattr(r, "grasped_n_points", 0) else None)
    return [(li, None if g < 0 else gp[g])
            for li, g in member_collision_points(r, section)]


def pack_multirobot_params(lay: MultiRobotLayout):
    """Members' models + base poses + rows + scene -> (ints int32, floats
    float32), the two buffers ``mr_terms.cu`` reads: ``pack_cost_params``'
    buffers of the layout (its members' FK steps, points, rows in the
    order object SDF, workspace, pairs as listed, and the scene), and,
    from the int that ints[13] holds on, the terms' int sections: a header
    of 8 (the block pairs n_bp, the row entries E, 0, the floats a lane of
    a warp's scratch on the route past 8 joints a member (``_mr_scratch``;
    0 on the register route), 0s), each member's joint count and first
    column, each block pair's members i and j (the n diagonal blocks, then
    (i, j), i < j, in order) and the first of its row entries (n_bp + 1),
    the value phase's row cuts (one range a warp, ``_mr_warps``; balanced
    by ``cost_row_ops``), each point's joint mask over its member's
    columns, and the row entries.  The kernel reads a member's prismatic
    joints from its FK steps.

    An entry is 8 times a row's index plus flags: 1, the pair's points in
    the other order (a mutual pair listed from member j to member i, so
    that its first point lies on member i); 2, the diagonal block's member
    holds the second point; 4, a mutual row on a diagonal block (its side
    of g and H; its cost is the cross block's).  A diagonal block i lists
    each of its object points' SDF row (with scene objects) and workspace
    row, its own pairs, then its side of every cross block's rows; a cross
    block (i, j) lists the pairs from member i to member j, then those from
    j to i: each block's g, H and cost add in that order.  A mutual pair
    between two object points of one member is listed as an own pair of
    that member's diagonal block: both points move with its columns, so it
    adds to H_ii alone."""
    ints, floats = pack_cost_params(lay)
    members = lay.members
    n_mem = len(members)
    obj_off = [int(v) for v in lay.obj_off]
    n_obj = obj_off[-1]
    n_sdf = n_obj if lay.df_obj_list else 0
    pair0 = n_sdf + n_obj                      # the first pair row
    own, groups = [[] for _ in members], {}
    for k, (pa, pb) in enumerate(zip(lay.pair_a, lay.pair_b)):
        if pa >= n_obj:                        # a member's own pair
            own[int(np.searchsorted(lay.self_off, pa, side="right")) - 1] \
                .append(pair0 + k)
            continue
        i, j = (int(np.searchsorted(obj_off, p, side="right")) - 1
                for p in (pa, pb))
        if i == j:                             # within one member
            own[i].append(pair0 + k)
            continue
        groups.setdefault((i, j), []).append(pair0 + k)
    bp = [(i, i) for i in range(n_mem)] + [
        (i, j) for i in range(n_mem) for j in range(i + 1, n_mem)]

    def cross_rows(i, j):
        return ([8 * r for r in groups.get((i, j), ())]
                + [8 * r + 1 for r in groups.get((j, i), ())])

    entries, begin = [], []
    for i, j in bp:
        begin.append(len(entries))
        if i != j:
            entries += cross_rows(i, j)
            continue
        for p in range(obj_off[i], obj_off[i + 1]):
            entries += ([8 * p] if n_sdf else []) + [8 * (n_sdf + p)]
        entries += [8 * r for r in own[i]]
        for a, b in bp[n_mem:]:
            if i in (a, b):
                entries += [e + 4 + (2 if i == b else 0)
                            for e in cross_rows(a, b)]
    begin.append(len(entries))

    anc = []
    for section in ("object", "self"):
        for r in members:
            a_m = r.model.ancestry_matrix()
            anc += [int(sum(1 << c for c in np.flatnonzero(a_m[li])))
                    for li, _ in member_collision_points(r, section)]
    ops = cost_row_ops(lay)
    scratch = _mr_scratch(lay.d_list, bp)
    # the row cuts are one range a warp: count the warps with the most
    # cuts a block can take (n_bp + 1) in its parameters
    sections = [lay.d_list, lay.d_off[:-1], [i for i, _ in bp],
                [j for _, j in bp], begin]
    n_ints = len(ints) + 8 + sum(len(x) for x in sections) + len(bp) + 1 \
        + len(anc) + len(entries)
    warps = _mr_warps(len(bp), scratch, _mr_lane_floats(ints), n_ints,
                      len(floats))
    extras = _i32([[len(bp), len(entries), 0, scratch, 0, 0, 0, 0]]
                  + sections + [_row_cuts(ops, warps), anc, entries])
    assert len(ops) == pair0 + len(lay.pair_a) and len(anc) == int(ints[2])
    ints[_MR_EXTRAS] = len(ints)
    return np.concatenate([ints, extras]), floats


def _mr_scratch(d_list, bp) -> int:
    """The floats a lane of a warp's scratch on mr_terms.cu's route past 8
    joints a member: the largest block's sums, a diagonal block's g_i and
    packed triangle (d_i (d_i + 3) / 2) or a cross block's d_i d_j; 0 on
    the register route."""
    if max(d_list) <= _MR_NARROW_DOF:
        return 0
    return max(d_list[i] * (d_list[i] + 3) // 2 if i == j
               else d_list[i] * d_list[j] for i, j in bp)


def _mr_lane_floats(ints) -> int:
    """The floats a lane of mr_terms.cu's shared memory holds besides the H
    scratch, from the cost header: its q, joint axes and origins (7 D),
    points (3 P), stored transforms (12 a slot), every row's value, each
    block pair's cost share (added by the caller) and each object row's
    minimizing primitive."""
    D, P, NO, K, NOBJ, n_slots = (int(ints[i]) for i in (1, 2, 3, 4, 5, 8))
    n_sdf = NO if NOBJ > 0 else 0
    return 7 * D + 3 * P + 12 * n_slots + n_sdf + NO + K + n_sdf


def _mr_warps(n_bp: int, scratch: int, lane_floats: int, n_ints: int,
              n_floats: int) -> int:
    """The warps a block of mr_terms.cu: one a block pair up to the route's
    threads (10 warps on the register route, 8 past 8 joints a member), and
    on the route past 8 joints the most whose H scratch keeps a block of
    32 lanes within the H100's 232,448 bytes (at least 1: a block that does
    not fit is refused by the launch shape)."""
    cap = (_MR_MAX_THREADS if scratch == 0 else _MR_WIDE_MAX_THREADS) // 32
    warps = min(n_bp, cap)
    fixed = 4 * (-(-n_ints // 4) * 4 + -(-n_floats // 4) * 4)
    while scratch and warps > 1 and fixed + 4 * _MR_LANES * (
            lane_floats + n_bp + warps * scratch) > _SMEM_MAX:
        warps -= 1
    return warps


def _mr_block(ints, n_floats: int, lanes=None):
    """``mr_terms_launch_config``'s shape and refusal (``_fit_block``)."""
    n_mem, P = int(ints[0]), int(ints[2])
    xs = ints[int(ints[_MR_EXTRAS]):]
    n_bp, E, scratch = int(xs[0]), int(xs[1]), int(xs[3])
    # the sections after the header: 2 n_mem, 3 n_bp + 1, the row cuts
    # (warps + 1), P masks, E entries
    warps = len(xs) - 8 - 2 * n_mem - 3 * n_bp - 1 - P - E - 1
    member_dof = int(max(xs[8:8 + n_mem]))
    lanes, smem, refusal = _fit_block(
        "MultiRobot terms", ints, n_floats,
        4 * (_mr_lane_floats(ints) + n_bp + warps * scratch),
        _MR_LANES if lanes is None else lanes, warps,
        _MR_MAX_THREADS if scratch == 0 else _MR_WIDE_MAX_THREADS)
    return dict(lanes=lanes, block_pairs=n_bp, warps=warps,
                member_dof=member_dof, threads=lanes * warps,
                smem_bytes=smem), refusal


def mr_terms_launch_config(ints, n_floats: int, lanes=None) -> dict:
    """Launch shape of ``mr_terms.cu`` from its packed buffers
    (``pack_multirobot_params``): ``lanes`` lanes a block, 32 unless given
    (a multiple of 32, whole warps fewer while the block passes the H100's
    232,448 bytes), ``warps`` warps of them (one a block pair, up to 10 on
    the register route and 8 past 8 joints a member: the packing's row
    cuts; ``threads`` = lanes * warps, at most 320 and 256), the
    ``block_pairs``, ``member_dof`` the widest member's joints (which picks
    the kernel's route), and the dynamic shared memory in bytes: the
    parameters, and per lane its q, joint axes and origins (7 D), points
    (3 P), stored transforms (12 a slot), every row's value, each block
    pair's cost share, each object row's minimizing primitive and, past 8
    joints a member, each warp's H scratch.  NotImplementedError where 32
    lanes do not fit."""
    launch, refusal = _mr_block(ints, n_floats, lanes)
    if refusal is not None:
        raise NotImplementedError(refusal)
    return launch


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
    float32), the buffers ``cost.cu`` reads (section order as in
    ``cost.cuh``'s parse_layout; K8 adds its own sections after them,
    ``pack_cost_kernel_params``) and the terms kernels start from
    (``pack_terms_params``, ``pack_multirobot_params``).  What a step or
    an object reads together is one record on a 16-byte boundary, read
    with 16-byte loads: a step's 8 ints (joint
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
    operations as the longest chain, at most 8; and at least D / 8, as a
    thread stages at most 8 of the lane's q columns."""
    return _cost_packing(lay)[:2]


def _cost_packing(lay):
    """``pack_cost_params``' buffers and each FK step's class
    (``_step_class``), in step order."""
    members = _cost_members(lay)
    mem_step, step_i, step_f, pt_list, fk_ops = [0], [], [], [], []
    offsets, step_cls = [], []
    n_slots, doff = 0, 0
    for model, base_R, _, points in members:
        steps, stored = _fk_steps(model, [li for _, li, _ in points])
        ctrl = list(model.controlled_link_idxs())
        slot_of, prev = {}, None
        identity = {-1: np.array_equal(np.asarray(base_R, np.float32),
                                       np.eye(3))}
        for k, i in enumerate(steps):
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
            keep_r = bool(i in stored or on_link or (
                k + 1 < len(steps) and model.parent_idx[steps[k + 1]] == i))
            step_cls.append(_step_class(model, i, identity, keep_r))
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
    # a thread stages at most kMaxQ q columns (cost.cu): past 8 joints a
    # single robot's rows split over more threads too
    T = max(T, min(_COST_MAX_TPL, -(-doff // _COST_MAX_Q)))
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
    return ints, floats, step_cls


# cost.cu's step classes: the coordinate axis of a revolute or continuous
# joint (1 x, 2 y, 3 z), that axis negative, R read later, the parent's
# rotation exactly I, the joint's rotation exactly F = I
_AXIS_NEG, _KEEP_R, _IDENTITY_PARENT, _IDENTITY_F = 4, 8, 16, 32


def _step_class(model, i, identity, keep_r: bool) -> int:
    """cost.cu's class of the FK step of link ``i``: what of the general
    step (``cost.cuh``: joint_transform, compose) is known exactly from the
    model (kin_scene.cuh's joint types: 1 revolute, 2 continuous, 0 fixed,
    3 prismatic).  ``identity`` maps each link computed so far (-1 the
    member's base) to whether its world rotation is exactly I, and gets
    link ``i``'s."""
    jt = int(model.joint_types[i])
    axis = np.asarray(model.joint_axis[i], np.float32)
    F = np.asarray(model.joint_fixed_rot[i], np.float32)
    cls = 0
    nz = np.flatnonzero(axis)
    if jt in (1, 2) and len(nz) == 1 and abs(axis[nz[0]]) == 1:
        cls = int(nz[0]) + 1 + (_AXIS_NEG if axis[nz[0]] < 0 else 0)
    rot_is_f = jt in (0, 3)
    f_is_identity = np.array_equal(F, np.eye(3))
    parent_identity = identity[int(model.parent_idx[i])]
    if parent_identity:
        cls |= _IDENTITY_PARENT
    elif rot_is_f and f_is_identity:
        cls |= _IDENTITY_F
    identity[i] = parent_identity and rot_is_f and f_is_identity
    return cls | (_KEEP_R if keep_r else 0)


def pack_cost_kernel_params(lay):
    """The two buffers ``cost.cu`` reads: ``pack_cost_params``' buffers,
    which the terms kernels also start from, with K8's own int sections
    after them, located by ints[14] and ints[15]: each FK step's class
    (``_step_class``), then, from a multiple of 4, each pair row's record
    (a, b, margin, guard), the margin and the guard m^2 (1 + 1e-6) as
    float32 bits (the guard rounded as the float expression ``m * m *
    1.000001f``)."""
    ints, floats, step_cls = _cost_packing(lay)
    m = lay.self_margins.cpu().numpy().astype(np.float32)
    guard = (m * m).astype(np.float32) * np.float32(1.000001)
    rec = np.stack([np.asarray(lay.pair_a, np.int32),
                    np.asarray(lay.pair_b, np.int32), m.view(np.int32),
                    guard.astype(np.float32).view(np.int32)], axis=1)
    ints[14] = len(ints)
    ints[15] = -(-(len(ints) + len(step_cls)) // 4) * 4
    pad = ints[15] - ints[14] - len(step_cls)
    return _i32([ints, step_cls, [0] * pad, rec]), floats


def _cost_block(ints, n_floats: int, lanes=None):
    """``cost_launch_config``'s shape and refusal (``_fit_block``)."""
    D, P, n_slots, T = (int(ints[i]) for i in (1, 2, 8, 9))
    if lanes is None:
        lanes = _COST_LANES if T == 1 else 32 * max(
            1, _COST_MAX_THREADS // (32 * T))
    lanes, smem, refusal = _fit_block(
        "cost", ints, n_floats, 4 * (D + 3 * P + 12 * n_slots + T), lanes,
        T, _COST_MAX_THREADS)
    if refusal is None and lanes not in _COST_LANE_COUNTS:
        refusal = ("the CUDA cost kernel is built for %s lanes a block, not "
                   "%d" % (", ".join(map(str, _COST_LANE_COUNTS)), lanes))
    return dict(lanes=lanes, threads_per_lane=T, threads=lanes * T,
                smem_bytes=smem), refusal


def cost_launch_config(ints, n_floats: int, lanes=None) -> dict:
    """Launch shape of ``cost.cu`` from its packed header: the T threads a
    lane that ``pack_cost_params`` scheduled, the lanes a block (128 at one
    thread a lane, else the whole warps of lanes that keep a block within
    256 threads, or ``lanes``; the kernel is built for 32, 64, 96 and 128),
    the dynamic shared memory in bytes (the parameters, and per lane its
    q, points, stored transforms and T partial sums).  NotImplementedError
    where 32 lanes pass the H100's 232,448 bytes or for another lane
    count."""
    launch, refusal = _cost_block(ints, n_floats, lanes)
    if refusal is not None:
        raise NotImplementedError(refusal)
    return launch


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
                     floats: torch.Tensor, d: int, launch: dict, grid=None):
    """Launch the CUDA terms kernel: q_cols (d, N) float32 contiguous CUDA
    -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,)); ``launch`` is
    ``terms_launch_config``'s shape for these buffers (another lane count
    a block gives the same bits by design); ``grid`` the scene's grid
    table when it has grids."""
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
                      Hqq.data_ptr(), cost.data_ptr(), N, d, launch["lanes"],
                      launch["smem_bytes"], ints.data_ptr(), ints.numel(),
                      floats.data_ptr(), floats.numel(), grid_ptr, stream)
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
    parameters (``pack_cost_kernel_params``): q_cols (d, N) float32
    contiguous CUDA -> unscaled cost (N,).  ``launch`` is
    ``cost_launch_config``'s shape
    (read from a host copy of ``ints`` when None); ``lanes`` launches at
    another lane count a block; ``grid`` the scene's grid table."""
    return _launch_cost(COST_KERNEL, q_cols, ints, floats, d, launch, lanes,
                        grid)


def run_multirobot_terms_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                                floats: torch.Tensor, d: int, launch: dict,
                                grid=None):
    """Launch the CUDA MultiRobot terms kernel: q_cols (d, N) float32
    contiguous CUDA -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,));
    ``launch`` is ``mr_terms_launch_config``'s shape for these buffers
    (another lane count a block gives the same bits by design); ``grid``
    the scene's grid table."""
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
                         g.data_ptr(), Hqq.data_ptr(), cost.data_ptr(), N, d,
                         launch["lanes"], launch["warps"],
                         launch["member_dof"], launch["smem_bytes"],
                         ints.data_ptr(), ints.numel(),
                         floats.data_ptr(), floats.numel(), grid_ptr, stream)
    return g, Hqq, cost


def run_multirobot_cost_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                               floats: torch.Tensor, d: int, launch=None,
                               lanes=None, grid=None):
    """``run_cost_kernel`` on a MultiRobot's packed parameters, counted on
    ``MR_COST_KERNEL``."""
    return _launch_cost(MR_COST_KERNEL, q_cols, ints, floats, d, launch,
                        lanes, grid)


def _refusal(task, members, multi: bool = False):
    """The words in which the CUDA terms and cost kernels refuse ``task``,
    whose robot's kinematic ``members`` they would run (the robot itself
    for a single robot, ``multi`` False), or None where they take it: a
    scene they do not take (``_scene_refusal``), more than MAX_DOF joints
    (MR_MAX_DOF in a member, for a MultiRobot), and for a MultiRobot more
    than MR_MAX_MEMBERS members or a member with interpolated points.
    Where the reference's fused factories return
    None for such a task, it runs its plain terms; here the task keeps
    them on the CPU and its hooks raise NotImplementedError with these
    words on a CUDA tensor."""
    refusal = _scene_refusal(task.df_obj_list)
    if refusal is not None:
        return refusal
    if not multi:
        if members[0].model.n_dofs > MAX_DOF:
            return "the CUDA terms kernel takes at most %d joints" % MAX_DOF
        return None
    if len(members) > MR_MAX_MEMBERS:
        return ("the CUDA MultiRobot terms kernel takes at most %d members"
                % MR_MAX_MEMBERS)
    refusal = _member_refusal(members)
    if refusal is not None:
        return refusal
    if any(r.model.n_dofs > MR_MAX_DOF for r in members):
        return ("the CUDA MultiRobot terms kernel takes at most %d "
                "joints per member" % MR_MAX_DOF)
    return None


def _member_refusal(members):
    """The MultiRobot kernels' words for a member with interpolated points
    (the reference's fused MultiRobot factories return None for it), or
    None.  A member with a learned self-collision net is taken: the
    reference's XLA MultiRobot terms and residuals, which it runs for such
    a member, read no member's net and keep its pair rows, and so do both
    kernels on the members' packing."""
    for r in members:
        if r.object_interpolate:
            return _MR_INTERP_WORDS
    return None


def _cost_refusal(task, members, multi: bool = False):
    """The words in which the CUDA cost kernel refuses ``task`` (its
    robot's kinematic ``members`` as ``_refusal``), or None where it takes
    it: a scene the kernels do not take, more than COST_MAX_MEMBERS
    members or COST_MAX_DOF joints (cost.cu: one member's FK a thread, at
    most 8 threads a lane, at most kMaxQ q columns a thread), and for a
    MultiRobot a member with interpolated points (the reference's
    collision_cost_pallas_factory returns None for it).  A member with a
    learned self-collision net is taken: the reference scores such a
    MultiRobot with 0.5 sum r^2 of its collision residuals (its cost
    factory returns None), rows that read no member's net, which is what
    this kernel sums on the members' packing.  The block is checked on the
    packing (``_cost_block``)."""
    refusal = _scene_refusal(task.df_obj_list)
    if refusal is not None:
        return refusal
    if len(members) > COST_MAX_MEMBERS:
        return ("the CUDA cost kernel takes at most %d members"
                % COST_MAX_MEMBERS)
    if sum(r.model.n_dofs for r in members) > COST_MAX_DOF:
        return "the CUDA cost kernel takes at most %d joints" % COST_MAX_DOF
    if not multi:
        return None
    return _member_refusal(members)


def _kernel_params(task):
    """(d, ints, floats, plain terms, launch shape) of a task the terms.cu
    kernels take, or None where the reference's fused factories return
    None (a point mass, robots without a kinematic model, interpolated
    collision points).  A task past the kernels' caps (``_refusal``, or a
    block that does not fit: ``terms_launch_config``) gets None for the
    buffers and the shape, and its refusal beside them: the hooks keep
    the plain version on the CPU and raise on a CUDA tensor.  A robot with
    a learned self-collision net packs no pair rows (its net row runs in
    ``csrc/net_row.cu``).  -> (params, refusal)"""
    from ..robots.point_mass import RobotPointMass
    robot = task.robot
    if isinstance(robot, RobotPointMass):
        return None, None
    if not hasattr(robot, "model") or robot.object_interpolate:
        return None, None
    plain = obstacle_terms_lanes_factory(task)
    ints = floats = launch = None
    refusal = _refusal(task, [robot])
    if refusal is None:
        ints_np, floats_np = pack_terms_params(plain.layout)
        launch, refusal = _terms_block(ints_np, len(floats_np))
        ints = torch.as_tensor(ints_np, device=task.device)
        floats = torch.as_tensor(floats_np, device=task.device)
    return (plain.layout.model.n_dofs, ints, floats, plain, launch), refusal


def _refused(refusal):
    """Raise a kernel's refusal (``_refusal``) when a tensor off the CPU
    reaches it."""
    if refusal is not None:
        raise NotImplementedError(refusal)


def obstacle_terms_kernel_factory(task):
    """GN obstacle terms of a kinematic robot in an analytic primitive
    scene, through the CUDA terms kernel for CUDA tensors, followed by the
    net row kernel for a robot with a learned self-collision net (None and
    the refusal as ``_kernel_params``); a ``MultiRobot`` goes to
    ``multirobot_terms_kernel_factory``."""
    from ..robots.multi_robot import MultiRobot
    if isinstance(task.robot, MultiRobot):
        return multirobot_terms_kernel_factory(task)
    params, refusal = _kernel_params(task)
    if params is None:
        return None
    d, ints, floats, plain, launch = params
    lay = plain.layout
    net_row = (None if lay.net is None or refusal is not None
               else NetRowParams(lay.net, lay.net_cutoff, task.device))
    grid = None if refusal is not None else scene_grid_table(lay.df_obj_list)

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        _refused(refusal)
        out = run_terms_kernel(q_cols, ints, floats, d, launch, grid)
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
    terms.refusal = refusal
    terms.net_row = net_row
    terms.grid = grid
    return terms


def collision_cost_kernel_factory(task, terms=None):
    """Per-waypoint collision cost 0.5 sum r^2 (unscaled) of the same tasks
    as the terms, through the CUDA cost kernel (``cost.cu``) for CUDA
    tensors, followed by the value-only net row kernel for a robot with a
    learned self-collision net (on the members' parameters for a
    ``MultiRobot``); the plain version is the cost output of the plain
    terms.  A task the cost kernel refuses (``_cost_refusal``, its own
    limits, not the terms kernels') keeps the plain cost on the CPU and
    raises the refusal on a CUDA tensor.  ``terms``, the task's hook from
    ``obstacle_terms_kernel_factory``, lends its plain terms, their
    layout, its net row and its scene's grid table, so they are built once
    per task (without it, the hook is built here)."""
    from ..robots.multi_robot import MultiRobot
    if not hasattr(terms, "params"):
        terms = obstacle_terms_kernel_factory(task)
        if terms is None:
            return None
    d, _, _, plain_terms, _ = terms.params
    multi = isinstance(task.robot, MultiRobot)
    refusal = _cost_refusal(task, task.robot.robots if multi
                            else [task.robot], multi)
    lay = plain_terms.layout
    net_row = grid = None
    if refusal is None:
        net_row = getattr(terms, "net_row", None)
        if net_row is None and lay.net is not None:
            net_row = NetRowParams(lay.net, lay.net_cutoff, task.device)
        grid = (terms.grid if terms.grid is not None
                else scene_grid_table(lay.df_obj_list))
    run = run_multirobot_cost_kernel if multi else run_cost_kernel
    if net_row is not None:
        def run(q_cols, ints, floats, d, launch, grid):
            cost = run_cost_kernel(q_cols, ints, floats, d, launch,
                                   grid=grid)
            add_net_cost(net_row, q_cols, cost)
            return cost
    return _cost_fn(plain_terms, task.device, d, run, grid, refusal)


def _cost_fn(plain_terms, device, d, run, grid, refusal):
    """cost(q_cols) on the plain terms' layout's cost packing: the kernel
    through ``run`` for a CUDA tensor (with the scene's grid table
    ``grid``), the plain terms' cost for a CPU tensor; with a refusal (the
    cost kernel's limits, ``_cost_refusal``, or its block) no packing, and
    the refusal raised on a CUDA tensor."""
    ints = floats = launch = None
    if refusal is None:
        ints_np, floats_np = pack_cost_kernel_params(plain_terms.layout)
        launch, refusal = _cost_block(ints_np, len(floats_np))
        ints = torch.as_tensor(ints_np, device=device)
        floats = torch.as_tensor(floats_np, device=device)

    def plain(q_cols):
        return plain_terms.unscaled(q_cols)[2]

    def cost(q_cols):
        if q_cols.device.type == "cpu":
            return plain(q_cols)
        _refused(refusal)
        return run(q_cols, ints, floats, d, launch, grid=grid)

    cost.plain = plain
    cost.params = (d, ints, floats, launch)
    cost.refusal = refusal
    cost.grid = grid
    return cost


def _mr_kernel_params(task):
    """(d, ints, floats, plain terms, launch shape) of a ``MultiRobot``
    task for the mr_terms.cu kernel, or None unless every member has a
    kinematic model; past the caps (``_refusal``, or a block that does not
    fit: ``mr_terms_launch_config``) None for the buffers and the shape,
    and the refusal beside them.  The plain terms are
    ``obstacle_terms_lanes_factory``'s: the block-structured assembly, or
    the generic padded one for a same-member mutual pair (with the
    reference's warning).  -> (params, refusal)"""
    robot = task.robot
    members = robot.robots
    if not all(hasattr(r, "model") for r in members):
        return None, None
    plain = obstacle_terms_lanes_factory(task)
    ints = floats = launch = None
    refusal = _refusal(task, members, multi=True)
    if refusal is None:
        ints_np, floats_np = pack_multirobot_params(plain.layout)
        launch, refusal = _mr_block(ints_np, len(floats_np))
        ints = torch.as_tensor(ints_np, device=task.device)
        floats = torch.as_tensor(floats_np, device=task.device)
    return (robot.q_dim, ints, floats, plain, launch), refusal


def multirobot_terms_kernel_factory(task):
    """GN obstacle terms of a ``MultiRobot`` task in an analytic primitive
    scene: the CUDA MultiRobot terms kernel for CUDA tensors, the plain
    terms (block-structured, or the generic padded assembly for a
    same-member mutual pair) for CPU tensors.  Same contract as
    ``obstacle_terms_kernel_factory``; None and the refusal as
    ``_mr_kernel_params``."""
    params, refusal = _mr_kernel_params(task)
    if params is None:
        return None
    d, ints, floats, plain, launch = params
    grid = (None if refusal is not None
            else scene_grid_table(plain.layout.df_obj_list))

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        _refused(refusal)
        return run_multirobot_terms_kernel(q_cols, ints, floats, d, launch,
                                           grid)

    def terms(q_cols, lam, h=None):
        if q_cols.device.type == "cpu":
            return plain(q_cols, lam, h=h)
        return embed_terms(*unscaled(q_cols), lam, h=h)

    terms.unscaled = unscaled
    terms.plain = plain
    terms.params = params
    terms.refusal = refusal
    terms.grid = grid
    return terms
