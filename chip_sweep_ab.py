"""Time the sweep kernels of this checkout against those of another checkout
of the repository (e.g. the parent commit), in turns, in one process on one
NVIDIA GPU.

    git archive <commit> | tar -x -C chip_checkout/other   # a git-ignored dir
    python3 chip_sweep_ab.py --other chip_checkout/other [--out FILE] \
        [--kernels all|sweep|riccati|cols|cols_wide|terms|net|cost|solvers|sdf]

The other checkout's ``csrc/btridiag.cu`` (and ``btridiag_sweep.cu`` where
it has one), ``csrc/riccati.cu`` and ``csrc/btridiag_cols.cu`` are built
beside this tree's (``ops.cuda_build``) and stand in for this tree's
libraries while its turn runs: the wrappers, problems and timing are this
tree's, so only the kernels differ (a launch function with another
argument list is called with the arguments its own tree's wrapper gave it:
the sweeps' lanes per block dropped, the Riccati sweep's device scratch
allocated).
Each measurement runs in the order other, this, this, other (each side's
time the mean of its two), on the problems of ``chip_smoke.py``.

``--kernels sweep`` (the block-tridiagonal sweeps):

- K2 at (64, 14, 1024) on the main path's first GN system, and at config
  2's (64, 4, 1024);
- K9's factor sweep at the reuse workload's (32, 14, 256), beside one
  ``torch.linalg.cholesky`` of the dense system;
- the main path (8 MPC steps of ``chip_smoke.run_mpc``): ms per step by
  CUDA events, and once per side a profile (device ms per step, busy
  share);
- the reuse workload's solve at refactor_every 1, 2, 4 (ms per iteration).

Each side's K2 and K9 outputs are held to float64 as ``chip_smoke.py``
holds them.  K9's substitution is timed in turns (device time over a
CUDA graph of calls) on the reuse system's factors with a fresh b, each
side held to float64, and the sides' bits compared (reported, not
required: the redesigned kernel's backward pass takes the sweep's order),
beside this tree's factor sweep timed the same way; this tree's
substitution is also timed at B = 256, 1024 and 4096 (the lanes
repeated) at 2, 4 and 8 lanes a block, through its ring of stages and
with L and W kept on chip between its passes (each must give its
launch's bits); the reuse runs get a profile per side.  K2 and K9's
factor sweep are compared bit for bit on the same inputs (required), and
K3's tails (reported).

``--kernels riccati`` (the iLQR path):

- K6 on the inputs of the iLQR path's first iteration (T = 31, P = 27, B =
  512) and of the tracking loop's first step (T = 15, P = 34), each
  side's output held to a float64 plain version as ``chip_smoke.py``
  holds it, the sides' bits compared;
- K7 on the path's inputs at T = 31, at the tracking loop's T = 15 and at
  a ragged B = 100: bit for bit the same on both sides (required), each
  held to float64, timed in turns (device time over a CUDA graph of
  calls), beside both sides' ptxas report of every ``rollout_kernel<D>``
  (an older rollout takes no lanes a block);
- this tree's K7 at 1, 2 and 4 lanes a block (``rollout_launch_config``
  with the lanes given, then the raw launch), each giving the wrapper's
  bits, timed in turns (1, 2, 4, 4, 2, 1; device time over a CUDA graph)
  at T = 31 and T = 15 (B = 512), at B = 100 and at B = 4096 (the path's
  inputs tiled), beside the lanes the wrapper picks;
- phase ``ilqr``'s solve (30 iterations, B = 512) and phase
  ``ilqr_mpc``'s tracking loop (30 steps): ms per iteration / step by CUDA
  events, and once per side a profile (device ms, busy share).

``--kernels cols`` (the column sweep, config 4's path):

- K4 at (32, 40, 40, 256) on phase ``mr_solve``'s GN system and on a
  random system: each side's x ``torch.equal`` to the other's, and held to
  float64 as ``chip_smoke.py`` holds it; this tree's kernel also timed at
  one and at two lanes a block, and at B = 8, 132 and 256;
- the multi-robot MPC (phase ``mr_mpc``, 30 steps): ms per step by CUDA
  events, and once per side a profile (device ms per step, busy share).

``--kernels cols_wide`` (K4's shared-memory route, ``btridiag_cols_wide.cu``,
five Pandas' path): the other tree's source stands in for this tree's
under this tree's wrapper (``cols_wide_swap``; an older kernel's scratch,
(B, H, m + 1, m), fits in the one this tree's wrapper gives):

- ptxas's report of both sides' instantiations;
- the route on phase ``mr_five``'s first GN system at (32, 70, 70, 256)
  and on random SPD systems at (32, m, m, 64), m = 96, 112 and 128
  (``chip_smoke.random_wide_system``): each side's x held to float64 as
  ``chip_smoke.py`` holds it (the GN rule, the random rule), the sides'
  largest difference, the device time over a CUDA graph of calls in
  turns, the bound and the speedup;
- five Pandas' MPC step (30 steps, ``chip_smoke.mr_rollout``) in turns by
  CUDA events, and once per side a profile (device ms per step, busy
  share).

``--kernels terms`` (the fused GN terms): the other tree's ``terms.cu``
(K1), ``mr_terms.cu`` (K5; an older tree's fed its own packing of the
same task, ``parent_mr_terms_params``) and ``cost.cu`` stand in for this
tree's under this tree's wrappers:

- ptxas's report of both sides' ``mr_terms_kernel`` and ``terms_kernel``;
- K5 on phase ``mr_terms``' four cases (config 4's first and random q,
  random q at the tight poses, the two-arm robot at N = 4096), on phase
  ``mr_grasp``'s and on phase ``mr_grid``'s first q: each side held to
  the plain version (``chip_smoke``'s terms tolerance, the grid rule in
  the grid scene), whether the sides agree bit for bit (and in how many
  lanes not), the kernel's device time in turns (over a CUDA graph of
  calls) and a call's (CUDA events), the bound;
- K1 (pair field, grasped, grid: its scene gradient is now
  ``cost.cuh``'s pick and gradient pair) and K8 (both branches) bit for
  bit, and K1's device time on each of its three q in turns (over a CUDA
  graph of calls);
- config 4's MPC step in turns, with a profile per side (device ms a
  step, busy share).

``--kernels net`` (the learned self-collision net row, K1's and K8's, in
``net_row.cu``): the other tree's ``net_row.cu`` (an older tree's single
FP32 kernel, whose launch functions take no route, fed the simt packing
and launch shape, which are that tree's own) stands in for this tree's
under this tree's wrappers:

- ptxas's report of both sides' net-row kernels;
- the K1 row (``trt_net_terms_launch``) from zeros on the main path's
  first q (N = 65,536) with the bundled net and the relu and tanh spread
  nets of ``chip_smoke.py``, and the K8 row (``trt_net_cost_launch``) on
  the net sGPMP path's candidates (N = 2,097,152) and proposal (N =
  131,072) with the bundled and the relu spread net: each side held to the
  plain version on the lanes away from the hinge (``chip_smoke``'s terms
  tolerance), the time in turns (CUDA events), both bounds;
- the net sGPMP iteration (10 iterations) and the net main path's step
  (8 MPC steps, the spread net) in turns, with a profile per side (device
  ms, busy share, the net row's device ms).

``--kernels cost`` (the value-only collision cost K8, ``cost.cu``, both
branches): the other tree's ``cost.cu`` stands in for this tree's under
this tree's wrappers and packing (``pack_cost_kernel_params``, whose
sections before ints 14-15 are the words an older cost.cu reads):

- ptxas's report of both sides' ``cost_kernel`` instantiations;
- K8 on every branch and shape of phases ``cost``, ``grid_cost``,
  ``grasp_cost``, ``mr_cost``, ``mr_grid`` and ``mr_grasp``: the pair-field,
  grid and grasped Panda at the iLQR line search's 79,360 (the path's
  first q for the pair field, random q for the others) and at the sGPMP
  acceptance's 131,072 and candidates' 2,097,152; config 4, in the grid
  and grasped at the acceptance's 8,192 and the candidates' 131,072.  Each
  side held to the plain version (``chip_smoke``'s terms tolerance, the
  grid rule in a grid scene), the lanes where the sides differ and by how
  much, the device time in turns (over a CUDA graph of calls), the bound;
- at 2,097,152, where each side's time goes: copies of both sides'
  cost.cu cut after each stage (``staged_cost_source``: FK alone, with
  the points, the object rows, the workspace rows; the whole adds the
  pairs), in turns;
- the sGPMP iteration (20 iterations) of the Panda, the grid and grasped
  Panda and grasped config 4 in ``SG_ROUNDS`` rounds of turns (50
  alternating pairs): each side's median wall ms and quartiles, those of
  the pairs' difference, the share of pairs this tree wins, whether that
  is a gain and whether this tree's side is not slower
  (``paired_wall``), beside a profile per side (device ms, busy share,
  K8's device ms and its saving).

``--kernels solvers`` (the L-and-y sweep K3, both tails, and block cyclic
reduction K11, which nothing routes to): the other tree's K3 and K11
stand in for this tree's under this tree's wrappers (``solvers_swap``).
An older tree's K3 is the one-thread kernel of ``btridiag_sweep.cu``,
whose ``trt_btridiag_sweep_launch`` takes no lanes a block: that library
stands in for the symbol this tree's wrapper calls in ``btridiag.cu``,
given the same arguments less the lanes (its L and y scratch have the
sizes this tree's wrapper allocates).  An older K11 takes no lanes or
threads a block and is given the rest (its work arrays fit in this
tree's):

- ptxas's report of both sides' K3 and K11 instantiations;
- K3 (trsm and trsv) and K11 on the main path's first GN system and a
  random system at (64, 14, 1024), on config 2's first GN system (64, 4,
  1024), on the main path's system tiled to B = 4096, and K11 on a random
  (256, 14, 1024) system: each side held to float64 on a GN system and
  to its plain version on a random one (``chip_smoke.hold_solve``), the
  sides' bits, this tree's trsm tail against K2, the device time over a
  CUDA graph of calls in turns, K2's beside them, the bound; K2 and K9's
  factor sweep bit for bit against the other tree's btridiag.cu;
- both sides' K11 launch by launch on the GN system (``launch_breakdown``,
  torch.profiler's kernel events);
- this tree's K11 at ten launch shapes (1-8 lanes, 32-256 threads a
  block; the same bits reported), beside its default.

``--kernels sdf`` (the point-cloud sphere SDF K10 and the GN assembly
K12): the other tree's ``sphere_sdf.cu`` and ``gn_assembly.cu`` stand in
for this tree's under this tree's wrappers (``sdf_swaps``; an older K10
takes no warps a block and is given the rest):

- ptxas's report of both sides' K10 and K12 instantiations, and both
  sides' SASS instructions a (point, sphere) pair of K10
  (``chip_smoke.sdf_pair_instructions``, with each side's SASS listing);
- K10 at M = 65,536 on phase ``point_cloud``'s cloud (S = 4,096 of radius
  0.02) and at S = 129, 512 and 16,384 (its first spheres, the last
  drawn the same way), with per-sphere radii 0.05-0.3 at S = 4,096 and
  4,173, and at M = 1,000: the sides' outputs bit for bit (required), the
  device time over a CUDA graph of calls in turns, the bound; this tree's
  K10 at 4, 8 and 16 warps a block at the main shape (the same bits);
- K12 on the main path's first (r, Jr) (P = 20, d = 7, N = 65,536) and
  at N = 1,000 and 999: the sides' outputs bit for bit (required); the
  device time in turns over a CUDA graph of calls with the inputs rotated
  over 3 copies (past the 50 MB L2) at N = 65,536 and 1,000, and at N =
  65,536 also on one copy (read from L2).

``--kernels all`` (the default) runs the sweeps and the Riccati sweep;
``cols``, ``cols_wide``, ``terms``, ``net``, ``cost``, ``solvers`` and
``sdf`` run alone.  Prints one JSON line per measurement, then the card's name and
power limit; ``--out`` writes all of it as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as cs


def other_kernel_class():
    """CudaKernel whose library is named by the other checkout's own source
    and headers."""
    import hashlib

    from torch_robotics_tpu_torch.ops.cuda_build import BUILD_DIR, CudaKernel

    class OtherKernel(CudaKernel):
        @property
        def library_path(self):
            h = hashlib.sha256(self.source.read_bytes())
            for header in sorted(self.source.parent.glob("*.cuh")):
                h.update(header.read_bytes())
            return BUILD_DIR / ("other-%s-%s.so" % (self.source.stem,
                                                    h.hexdigest()[:16]))
    return OtherKernel


def other_sweep_kernels(csrc: Path):
    """The other checkout's btridiag.cu kernels and its K3 (``other_k3``),
    with the argtypes its launch functions take (an older sweep takes no
    lanes-per-block argument)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    OtherKernel = other_kernel_class()
    takes_lanes = "int lanes" in (csrc / "btridiag.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    sweep = [P] * 7 + [I] * (4 if takes_lanes else 3) + [P]
    main = OtherKernel(str(csrc / "btridiag.cu"), {
        "trt_btridiag_w_launch": sweep,
        "trt_btridiag_factor_launch": sweep,
        "trt_btridiag_subst_launch": bk.SUBST_KERNEL.functions[
            "trt_btridiag_subst_launch"]})
    return main, other_k3(csrc), takes_lanes


def other_k3(csrc: Path):
    """The other checkout's L-and-y sweep (K3): its one-thread kernel in
    ``btridiag_sweep.cu`` (a tree before K3 joined btridiag.cu; its launch
    function takes no lanes a block, ``one_thread`` True) or the L-and-y
    modes of its ``btridiag.cu``."""
    import ctypes

    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    OtherKernel = other_kernel_class()
    one_thread = (csrc / "btridiag_sweep.cu").is_file()
    P, I = ctypes.c_void_p, ctypes.c_int
    return OtherKernel(
        str(csrc / ("btridiag_sweep.cu" if one_thread else "btridiag.cu")),
        {"trt_btridiag_sweep_launch": [P] * 6 + [I] * (4 if one_thread
                                                       else 5) + [P]}), \
        one_thread


def other_cr_kernel(csrc: Path):
    """The other checkout's block cyclic reduction (K11, ``btridiag_cr.cu``)
    and whether it is the one-launch kernel (its launch function takes
    lanes and threads a block; an older one launches a kernel per stage
    and takes neither)."""
    import ctypes
    OtherKernel = other_kernel_class()
    one_launch = "int lanes" in (csrc / "btridiag_cr.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    return OtherKernel(str(csrc / "btridiag_cr.cu"), {
        "trt_btridiag_cr_launch": [P] * 10 + [I] * (6 if one_launch else 4)
        + [P]}), one_launch


def other_sdf_kernels(csrc: Path):
    """The other checkout's sphere_sdf.cu (K10) and gn_assembly.cu (K12),
    and whether its K10 takes warps a block (an older one does not)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import gn_assembly_kernel as gk
    OtherKernel = other_kernel_class()
    sdf_shape = "int warps" in (csrc / "sphere_sdf.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    return (OtherKernel(str(csrc / "sphere_sdf.cu"), {
        "trt_sphere_sdf_launch": [P] * 4 + [I] * (3 if sdf_shape else 2)
        + [P]}), sdf_shape,
        OtherKernel(str(csrc / "gn_assembly.cu"), dict(gk.KERNEL.functions)))


def other_cols_kernel(csrc: Path):
    """The other checkout's btridiag_cols.cu, with the argtypes of its
    launch function (an older column sweep takes no lanes-per-block
    argument)."""
    import ctypes
    OtherKernel = other_kernel_class()
    takes_lanes = "int lanes" in (csrc / "btridiag_cols.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    return OtherKernel(str(csrc / "btridiag_cols.cu"), {
        "trt_btridiag_cols_launch":
            [P] * 5 + [I] * (4 if takes_lanes else 3) + [P]}), takes_lanes


def other_cols_wide_kernel(csrc: Path):
    """The other checkout's btridiag_cols_wide.cu (its launch function
    takes this tree's arguments)."""
    import ctypes
    OtherKernel = other_kernel_class()
    P, I = ctypes.c_void_p, ctypes.c_int
    return OtherKernel(str(csrc / "btridiag_cols_wide.cu"), {
        "trt_btridiag_cols_wide_launch": [P] * 5 + [I] * 4 + [P]})


def other_riccati_kernel(csrc: Path):
    """The other checkout's riccati.cu, with the argtypes of its launch
    functions (an older sweep takes a device scratch Fw (M, P, B) and no
    launch shape; an older rollout no lanes a block)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import riccati_kernel as rk
    OtherKernel = other_kernel_class()
    text = (csrc / "riccati.cu").read_text()
    takes_fw = "float* Fw" in text
    roll_lanes = "int lanes, float dt" in text
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sweep = ([P] * 7 + [I] * 4 + [F] * 6 + [P] if takes_fw
             else rk.RICCATI_KERNEL.functions["trt_riccati_launch"])
    roll = (rk.ROLLOUT_KERNEL.functions["trt_rollout_launch"] if roll_lanes
            else [P] * 7 + [I] * 4 + [F] * 2 + [P])
    return OtherKernel(str(csrc / "riccati.cu"), {
        "trt_riccati_launch": sweep, "trt_rollout_launch": roll}), \
        takes_fw, roll_lanes


def other_net_kernel(csrc: Path):
    """The other checkout's net_row.cu, with the argtypes of its launch
    functions (a tree without routes takes no route and no length)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import net_kernel as nk
    OtherKernel = other_kernel_class()
    routed = "int route" in (csrc / "net_row.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    functions = ({**nk.NET_TERMS_KERNEL.functions,
                  **nk.NET_COST_KERNEL.functions} if routed else {
        "trt_net_terms_launch": [P, P, P, P, I, I, I, P, P, P],
        "trt_net_cost_launch": [P, P, I, I, I, P, P, P]})
    return OtherKernel(str(csrc / "net_row.cu"), functions), routed


def other_terms_kernels(csrc: Path):
    """The other checkout's terms.cu (K1), mr_terms.cu (K5) and cost.cu
    (K8), with the argtypes of its K5 launch function (a tree before the
    shared-memory K5 takes (q, g, h, cost, N, n_bp, shared_bytes, ip, fp,
    grid, stream) and its own packing, ``parent_mr_terms_params``; a tree
    before K5's warps walked block pairs takes no warps or member_dof,
    one warp a block pair, on this tree's packing of at most 4 members of
    at most 8 joints) -> (K1, K5, K8, older, no_warps)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    OtherKernel = other_kernel_class()
    src = (csrc / "mr_terms.cu").read_text()
    older = "int n_ints" not in src
    no_warps = not older and "int member_dof" not in src
    P, I = ctypes.c_void_p, ctypes.c_int
    terms = OtherKernel(str(csrc / "terms.cu"), dict(tk.KERNEL.functions))
    mr = OtherKernel(str(csrc / "mr_terms.cu"), {
        "trt_mr_terms_launch": (
            [P] * 4 + [I] * 3 + [P] * 4 if older
            else [P] * 4 + [I] * 5 + [P, I, P, I, P, P] if no_warps
            else tk.MR_KERNEL.functions["trt_mr_terms_launch"])})
    cost = OtherKernel(str(csrc / "cost.cu"), dict(tk.COST_KERNEL.functions))
    return terms, mr, cost, older, no_warps


def parent_mr_terms_params(lay):
    """The packing of a tree before the shared-memory K5: (ints int32,
    floats float32, block pairs, dynamic shared memory in bytes) in the
    section order of its mr_terms.cu parse_layout (members' models by
    link, block pairs, points, own and mutual rows, scene)."""
    import numpy as np

    from torch_robotics_tpu_torch.ops import terms_kernel as tk
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
            for li, off in tk._member_points(r, section):
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

    scene_i, scene_f = tk._pack_scene(lay.df_obj_list,
                                       lay.ws_min.shape[0])
    n_obj = obj_off[-1]
    header = [n_mem, robot.q_dim, len(pt_member), n_obj, len(own_a),
              len(mut_a), len(lay.df_obj_list), len(scene_i[1]), len(bp),
              int(l_off[-1]), len(scene_i[5]), len(goff)] + [0] * 4
    ints = tk._i32([header, L_list, lay.d_list, lay.d_off[:-1], l_off[:-1],
                    obj_off[:-1], obj_off[1:],
                    [b for b, _ in own_range], [e for _, e in own_range],
                    [i for i, _ in bp], [j for _, j in bp],
                    [b for b, _ in bp_range], [e for _, e in bp_range],
                    topo, parent, jtype, qidx, ctrl, pt_member, pt_link,
                    pt_anc, pt_goff, own_a, own_b, mut_a, mut_b] + scene_i)
    floats = tk._f32(
        [np.concatenate([m.joint_trans.reshape(-1) for m in models]),
         np.concatenate([m.joint_fixed_rot.reshape(-1) for m in models]),
         np.concatenate([m.joint_axis.reshape(-1) for m in models]),
         np.concatenate([m.clamp_lower for m in models]),
         np.concatenate([m.clamp_upper for m in models]),
         robot.base_rots.cpu().numpy(), robot.base_trans.cpu().numpy(),
         lay.obj_thresh.cpu().numpy(), own_m, mut_m,
         lay.ws_min.cpu().numpy(), lay.ws_max.cpu().numpy(),
         np.zeros((0, 3)) if not goff else np.stack(goff)] + scene_f)
    P, D, n_bp = len(pt_member), robot.q_dim, len(bp)
    return ints, floats, n_bp, 4 * 32 * (3 * P + 6 * D + n_bp)


class Swap:
    """Stands in for this tree's kernels (a wrapper module's globals) while
    the other side's turn runs; ``launch`` routes each launch function to
    the other tree's library, with its own arguments."""

    def __init__(self, module, names, route):
        self.module, self.names, self.route = module, names, route
        self.launches = 0

    def launch(self, name, *args):
        routed = self.route(name, args)
        kernel, args = routed[:2]
        kernel.launch(routed[2] if len(routed) > 2 else name, *args)
        self.launches += 1

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            setattr(self.module, n, self)
        return self

    def __exit__(self, *exc):
        for n, k in self.saved.items():
            setattr(self.module, n, k)


def sweep_swap(main, k3, takes_lanes):
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    k3_route = solvers_swap(k3, (None, True)).route

    def route(name, args):
        if name == "trt_btridiag_sweep_launch":
            return k3_route(name, args)
        if (name in ("trt_btridiag_w_launch", "trt_btridiag_factor_launch")
                and not takes_lanes):
            args = args[:10] + args[11:]          # drop lanes_per_block
        return main, args
    return Swap(bk, ("KERNEL", "FACTOR_KERNEL", "SUBST_KERNEL",
                     "SWEEP_KERNEL"), route)


def solvers_swap(k3, cr):
    """The other tree's K3 and K11 under this tree's wrappers: ``k3`` and
    ``cr`` are (kernel, older) pairs from ``other_k3`` and
    ``other_cr_kernel``.  An older K3 is called without this tree's lanes
    a block; it takes the same scratch, L (H M^2 B floats) and y (H M B),
    in its own layout.  An older K11 is called without lanes and threads;
    its work arrays (H2 / 2 blocks) fit in this tree's (H2 - 1)."""
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk

    def route(name, args):
        if name == "trt_btridiag_sweep_launch":
            # (D, U, b, x, Ls, ys, H, M, B, trsv, lanes, stream)
            kernel, one_thread = k3
            return kernel, (args[:10] + args[11:] if one_thread else args)
        # (D, U, b, x, A, C, beta, Dw, Uw, bw, H, H2, M, B, lanes, threads,
        # stream)
        kernel, one_launch = cr
        return kernel, (args if one_launch else args[:14] + args[16:])
    return Swap(bk, ("SWEEP_KERNEL", "CR_KERNEL"), route)


def sdf_swaps(sdf, sdf_shape, gn):
    """(K10's swap, K12's swap): the other tree's kernels under this
    tree's wrappers, an older K10 called without warps a block."""
    from torch_robotics_tpu_torch.ops import gn_assembly_kernel, sdf_kernel

    def sdf_route(name, args):
        # (points, centers, radii, out, M, S, warps, stream)
        return sdf, (args if sdf_shape else args[:6] + args[7:])
    return (Swap(sdf_kernel, ("KERNEL",), sdf_route),
            Swap(gn_assembly_kernel, ("KERNEL",), lambda name, args: (gn,
                                                                     args)))


def cols_swap(other, takes_lanes):
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk

    def route(name, args):
        # (D, U, b, x, Lg, H, m, B, lanes, stream): drop lanes for an older
        # kernel (its scratch, (B, H, m, m), fits in the one given)
        return other, (args if takes_lanes else args[:8] + args[9:])
    return Swap(bk, ("COLS_KERNEL",), route)


def cols_wide_swap(other):
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    return Swap(bk, ("COLS_WIDE_KERNEL",), lambda name, args: (other, args))


def riccati_swap(other, takes_fw, roll_lanes):
    import torch
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk

    def route(name, args):
        if name == "trt_rollout_launch" and not roll_lanes:
            # (xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A, D, lanes, dt,
            # half_dt2, stream): an older rollout takes no lanes a block
            return other, args[:11] + args[12:]
        if name == "trt_riccati_launch" and takes_fw:
            # (U, l, Fc, Vx0, ks, Ks, P, T, B, D, lanes, stages, 6 floats,
            # stream) -> (U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, D, 6 floats,
            # stream); Fw is freed after the launch, in stream order
            P, T, B, D = args[6:10]
            fw = torch.empty((2 * D, P, B), dtype=torch.float32,
                             device="cuda")
            args = args[:6] + (fw.data_ptr(),) + args[6:10] + args[12:]
        return other, args
    return Swap(rk, ("RICCATI_KERNEL", "ROLLOUT_KERNEL"), route)


def net_swap(other, routed, rows):
    """The other tree's net-row kernels under this tree's wrappers: a launch
    on the parameters of one of ``rows`` (NetRowParams) goes to the other
    tree with the simt packing and launch shape of that net (an older
    tree's own), or as it is where the other tree takes routes."""
    import torch
    from torch_robotics_tpu_torch.ops import net_kernel as nk
    table = {}
    for row in rows:
        ints, floats = nk._pack_simt(row.net, row.cutoff)
        cfg = nk._simt_launch(row.net.widths)
        bufs = (torch.as_tensor(ints, device=row.ints.device),
                torch.as_tensor(floats, device=row.ints.device))
        table[row.ints.data_ptr()] = (cfg["lanes"], cfg["smem_bytes"], bufs)

    def route(name, args):
        if routed:
            return other, args
        if name == "trt_net_terms_launch":
            # (q, g, h, cost, N, route, lanes, smem, ip, fp, n_floats,
            # stream) -> (q, g, h, cost, N, lanes, smem, ip, fp, stream)
            lanes, smem, (ip, fp) = table[args[8]]
            return other, args[:5] + (lanes, smem, ip.data_ptr(),
                                      fp.data_ptr(), args[11])
        # (q, cost, N, route, lanes, smem, ip, fp, n_floats, stream)
        lanes, smem, (ip, fp) = table[args[6]]
        return other, args[:3] + (lanes, smem, ip.data_ptr(), fp.data_ptr(),
                                  args[9])
    return Swap(nk, ("NET_TERMS_KERNEL", "NET_COST_KERNEL"), route)


def terms_swap(terms, mr, cost, older, no_warps, tasks):
    """The other tree's K1, K5 and K8 under this tree's wrappers: an older
    K5 gets that tree's packing of the MultiRobot task whose parameters a
    launch carries (``parent_mr_terms_params``), a K5 before the warps
    walked block pairs this tree's arguments without warps and member_dof
    (its block pairs are its warps); K1 and K8 take the same arguments on
    both sides."""
    import torch
    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    table = {}
    for task in tasks:
        hook = task.collision_residuals.obstacle_terms_lanes
        ints, floats, n_bp, smem = parent_mr_terms_params(hook.plain.layout)
        table[hook.params[1].data_ptr()] = (
            torch.as_tensor(ints, device="cuda"),
            torch.as_tensor(floats, device="cuda"), n_bp, smem)

    def route(name, args):
        if name == "trt_mr_terms_launch" and older:
            # (q, g, h, cost, N, D, lanes, warps, member_dof, smem, ip,
            # n_ints, fp, n_floats, grid, stream) -> (q, g, h, cost, N,
            # n_bp, shared_bytes, ip, fp, grid, stream)
            i_o, f_o, n_bp, smem = table[args[10]]
            return mr, args[:5] + (n_bp, smem, i_o.data_ptr(),
                                   f_o.data_ptr(), args[14], args[15])
        if name == "trt_mr_terms_launch" and no_warps:
            # -> (q, g, h, cost, N, D, lanes, n_bp, smem, ip, n_ints, fp,
            # n_floats, grid, stream)
            return mr, args[:8] + args[9:]
        return {"trt_terms_launch": terms, "trt_mr_terms_launch": mr,
                "trt_cost_launch": cost}[name], args
    return Swap(tk, ("KERNEL", "MR_KERNEL", "COST_KERNEL", "MR_COST_KERNEL"),
                route)


def in_turns(swap, fn):
    """fn() in the order other, this, this, other -> (other's mean, this
    tree's mean, the four results in that order)."""
    out = []
    for side in ("other", "this", "this", "other"):
        with (swap if side == "other" else _null()):
            out.append(fn())
    return (out[0] + out[3]) / 2, (out[1] + out[2]) / 2, out


def main() -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--kernels",
                    choices=("all", "sweep", "riccati", "cols", "cols_wide",
                             "terms", "net", "cost", "solvers", "sdf"),
                    default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script times "
                "CUDA kernels")
    from torch_robotics_tpu_torch.ops.cuda_build import build_all
    csrc = (args.other / "torch_robotics_tpu_torch" / "csrc").resolve()
    do_sweep = args.kernels in ("all", "sweep")
    do_riccati = args.kernels in ("all", "riccati")
    do_cols = args.kernels == "cols"
    do_cols_wide = args.kernels == "cols_wide"
    do_terms = args.kernels == "terms"
    do_net = args.kernels == "net"
    do_cost = args.kernels == "cost"
    do_solvers = args.kernels == "solvers"
    do_sdf = args.kernels == "sdf"
    sweep_k = other_sweep_kernels(csrc) if do_sweep else None
    net_k = other_net_kernel(csrc) if do_net else None
    ric_k = other_riccati_kernel(csrc) if do_riccati else None
    cols_k = other_cols_kernel(csrc) if do_cols else None
    wide_k = other_cols_wide_kernel(csrc) if do_cols_wide else None
    terms_k = other_terms_kernels(csrc) if do_terms else None
    solv_k = ((other_k3(csrc), other_cr_kernel(csrc)),
              other_sweep_kernels(csrc)) if do_solvers else None
    sdf_k = other_sdf_kernels(csrc) if do_sdf else None
    cost_k = (other_terms_kernels(csrc)[2], {
        "other": cost_stage_kernels(csrc, "other"),
        "this": cost_stage_kernels(
            Path(cs.__file__).resolve().parent / "torch_robotics_tpu_torch"
            / "csrc", "this")}) if do_cost else None
    build_all([*((sweep_k[0], sweep_k[1][0]) if do_sweep else ()),
               *(ric_k[:1] if do_riccati else ()),
               *(cols_k[:1] if do_cols else ()),
               *((wide_k,) if do_cols_wide else ()),
               *(terms_k[:3] if do_terms else ()),
               *(net_k[:1] if do_net else ()),
               *((cost_k[0], *cost_k[1]["other"], *cost_k[1]["this"])
                 if do_cost else ()),
               *((solv_k[0][0][0], solv_k[0][1][0], solv_k[1][0])
                 if do_solvers else ()),
               *((sdf_k[0], sdf_k[2]) if do_sdf else ()),
               *cs.all_kernels().values()])
    report = {}

    def emit(name, **fields):
        report[name] = fields
        print(json.dumps({"ab": name, **fields}), flush=True)

    if do_riccati:
        ab_riccati(riccati_swap(*ric_k), ric_k[0], emit)
        torch.cuda.empty_cache()
    if do_sweep:
        ab_sweeps(sweep_swap(*sweep_k), emit)
    if do_cols:
        ab_cols(cols_swap(*cols_k), emit)
    if do_cols_wide:
        ab_cols_wide(cols_wide_swap(wide_k), wide_k, emit)
    if do_terms:
        ab_terms(terms_k, emit)
    if do_net:
        ab_net(*net_k, emit)
    if do_cost:
        ab_cost(*cost_k, emit)
    if do_solvers:
        ab_solvers(solvers_swap(*solv_k[0]), solv_k[0],
                   sweep_swap(*solv_k[1]), emit)
    if do_sdf:
        ab_sdf(sdf_swaps(*sdf_k), (sdf_k[0], sdf_k[2]), emit)
    emit("profiler", launches_without_kernel=cs.PROFILE_MISSED)

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, **report}, indent=1))


def ptxas_report(kernel, fragment):
    """ptxas's lines for the entry functions of ``kernel``'s build whose
    mangled names hold ``fragment``."""
    lines = kernel.library_path.with_suffix(".log").read_text().splitlines()
    return [" | ".join(x.strip().split("info    : ")[-1]
                       for x in lines[i + 1:i + 4])
            for i, line in enumerate(lines)
            if "Compiling entry function" in line and fragment in line]


def rollout_at_lanes(args, ins, lanes):
    """This tree's K7 on ``ins`` (contiguous float32, 16-byte aligned) at
    ``lanes`` lanes a block: the launch shape of ``rollout_launch_config``
    with the lanes given, then the raw launch -> fn() -> (xs_new,
    U_new)."""
    import torch
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk
    d, m, T, dt, alphas = args
    A, B = len(alphas), ins[0].shape[-1]
    cfg = rk.rollout_launch_config(d, A, B, lanes)
    kw = dict(dtype=torch.float32, device="cuda")
    al = torch.tensor(alphas, **kw)
    xs_new, U_new = torch.empty((A, T, m, B), **kw), torch.empty(
        (A, T, d, B), **kw)

    def run():
        rk.ROLLOUT_KERNEL.launch(
            "trt_rollout_launch", *(t.data_ptr() for t in ins),
            al.data_ptr(), xs_new.data_ptr(), U_new.data_ptr(), T, B, A, d,
            cfg["lanes_per_block"], dt, 0.5 * dt * dt,
            torch.cuda.current_stream().cuda_stream)
        return xs_new, U_new
    return run


def ab_riccati(swap, other, emit):
    """K6 at T = 31 and T = 15; K7 at T = 31, T = 15 and a ragged B = 100,
    bit for bit, in turns; both sides' ptxas for K7; phase ilqr's ms per
    iteration and ilqr_mpc's ms per step, each with a profile per side."""
    import torch
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve

    emit("ptxas", **{side: {"rollout_kernel<%d>" % d: ptxas_report(
        k, "rollout_kernelILi%dE" % d) for d in range(1, 9)}
        for side, k in (("other", other), ("this", rk.ROLLOUT_KERNEL))})
    task, start, goal = cs.ilqr_problem("cuda")
    seen = cs.capture_first_iteration(task, start, goal)
    mpc_seen = cs.capture_mpc_first(task, start, goal)
    for name, (s_args, ins) in (("k6_T%d" % seen["sweep"][0][3],
                                 seen["sweep"]),
                                ("k6_T%d" % mpc_seen["sweep"][0][3],
                                 mpc_seen["sweep"])):
        fn = rk.riccati_backward_kernel_factory(*s_args)
        ref = fn.plain(*ins)
        ref64 = fn.plain(*[t.double() for t in ins])
        rel_p64 = cs.max_errs([r.double() for r in ref], ref64)[1]
        errs, outs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                got = outs[side] = [g.clone() for g in fn(*ins)]
            rel_k64 = cs.max_errs([g.double() for g in got], ref64)[1]
            cs.check(all(bool(torch.isfinite(g).all()) for g in got)
                     and rel_k64 <= 2.0 * rel_p64 + cs.RICCATI_TOL,
                     "%s_%s: kernel vs float64 %.3g, plain float32 %.3g"
                     % (name, side, rel_k64, rel_p64))
            errs[side] = dict(kernel_vs_f64=rel_k64, plain_vs_f64=rel_p64)
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(lambda: fn(*ins), iters=20))
        d, m, P, T = s_args[:4]
        B = ins[0].shape[-1]
        emit(name, shape=dict(T=T, d=d, P=P, B=B), other_ms=other_ms,
             this_ms=this_ms, speedup=other_ms / this_ms, turns_ms=turns,
             bound_ms=cs.bound_ms(*cs.riccati_work(d, m, P, T, B))[0],
             launch=rk.riccati_launch_config(d, P, B), vs_float64=errs,
             bit_for_bit=all(torch.equal(a, b) for a, b in zip(
                 outs["other"], outs["this"])))

    # K7 on the path's inputs at T = 31 and 15 and at a ragged B = 100:
    # bit for bit, each side held to a float64 plain version as phase
    # riccati holds it, and timed in turns (device time over a CUDA graph
    # of calls: a call's host time is near its device time)
    r_args, r_ins = seen["roll"]
    m_args, m_ins = mpc_seen["roll"]
    for name, args, ins in (
            ("k7_T%d" % r_args[2], r_args, r_ins),
            ("k7_T%d" % m_args[2], m_args, m_ins),
            ("k7_T%d_B100" % r_args[2], r_args,
             [t[..., :100].contiguous() for t in r_ins])):
        roll = rk.linesearch_rollout_kernel_factory(*args)
        ref64 = roll.plain(*[t.double() for t in ins])
        rel_p64 = cs.max_errs([r.double() for r in roll.plain(*ins)],
                              ref64)[1]
        outs, errs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                outs[side] = [o.clone() for o in roll(*ins)]
            rel_k64 = cs.max_errs([o.double() for o in outs[side]],
                                  ref64)[1]
            cs.check(rel_k64 <= 2.0 * rel_p64 + cs.ROLLOUT_TOL,
                     "%s_%s: kernel vs float64 %.3g, plain float32 %.3g"
                     % (name, side, rel_k64, rel_p64))
            errs[side] = dict(kernel_vs_f64=rel_k64, plain_vs_f64=rel_p64)
        same = all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                     outs["this"]))
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.device_ms(lambda: roll(*ins), iters=20))
        d, m, T, _, alphas = args
        B = ins[0].shape[-1]
        emit(name, shape=dict(T=T, d=d, A=len(alphas), B=B),
             bit_for_bit=same, vs_float64=errs, other_ms=other_ms,
             this_ms=this_ms, speedup=other_ms / this_ms, turns_ms=turns,
             bound_ms=cs.bound_ms(*cs.rollout_work(d, m, T, len(alphas),
                                                   B))[0],
             launch=rk.rollout_launch_config(d, len(alphas), B))
        if not same:
            cs.fail("%s differs from the other tree's" % name)

    # this tree's K7 at 1, 2 and 4 lanes a block, in turns
    for name, args, ins in (
            ("k7_lanes_T%d" % r_args[2], r_args, r_ins),
            ("k7_lanes_T%d" % m_args[2], m_args, m_ins),
            ("k7_lanes_T%d_B100" % r_args[2], r_args,
             [t[..., :100] for t in r_ins]),
            ("k7_lanes_T%d_B4096" % r_args[2], r_args,
             [torch.cat([t] * 8, -1) for t in r_ins])):
        ins = [t.contiguous().clone() for t in ins]   # 16-byte aligned
        want = rk.linesearch_rollout_kernel_factory(*args)(*ins)
        runs = {n: rollout_at_lanes(args, ins, n) for n in (1, 2, 4)}
        for n, run in runs.items():
            if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                cs.fail("%s: other bits at %d lanes a block" % (name, n))
        ms = {n: [] for n in runs}
        for n in (1, 2, 4, 4, 2, 1):
            ms[n].append(cs.device_ms(runs[n], iters=20))
        d, m, T, _, alphas = args
        B = ins[0].shape[-1]
        mean = {n: sum(v) / len(v) for n, v in ms.items()}
        emit(name, shape=dict(T=T, d=d, A=len(alphas), B=B),
             ms_by_lanes_a_block=mean, turns_ms=ms,
             fastest=min(mean, key=mean.get),
             picked=rk.rollout_launch_config(d, len(alphas),
                                             B)["lanes_per_block"])

    # phase ilqr's solve and phase ilqr_mpc's loop
    params = ILQRParams(**cs.IL_PARAMS)

    def solve():
        return ilqr_solve(task.collision_residuals, start, goal, params,
                          q_limits=cs.ilqr_limits(task))

    def events_ms(fn):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1), out

    def profiles(fn, n_units):
        prof = {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                busy, dev_ms, top = cs.profile_device(fn, n_units)
            prof[side] = dict(profiled_device_busy_share=busy,
                              profiled_device_ms_per_unit=dev_ms,
                              top_device_ms_per_unit=top)
        return prof

    plan = solve().trajs
    with swap:
        solve()
    other_ms, this_ms, turns = in_turns(
        swap, lambda: events_ms(solve)[0] / cs.IL_ITERS)
    emit("ilqr_iteration", B=cs.IL_B, H=cs.IL_H, iterations=cs.IL_ITERS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, profile=profiles(solve, cs.IL_ITERS))

    def mpc(n_steps=cs.MPC_STEPS):
        return cs.ilqr_mpc_loop(task, start, goal, plan, n_steps)
    mpc(1)
    with swap:
        mpc(1)
    other_ms, this_ms, turns = in_turns(
        swap, lambda: events_ms(mpc)[0] / cs.MPC_STEPS)
    emit("ilqr_mpc_step", B=cs.IL_B, H=cs.MPC_H, steps=cs.MPC_STEPS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, profile=profiles(lambda: mpc(5), 5))


def ab_sweeps(swap, emit):
    """K2 at m = 14 and 4, K9's factor and substitution, K3, K2 and K9's
    factor bit for bit, the main path's step, reuse k = 1, 2, 4."""
    import numpy as np
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_solve
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core, solve_lanes_factor_core, solve_lanes_subst_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system

    def hold(name, fn, D, U, b, factor=False):
        """Each side's output against float64 (chip_smoke.hold_solve)."""
        plain = solve_lanes_factor_core if factor else solve_lanes_core
        ref = plain(D.double(), U.double(), b.double())
        p32 = plain(D, U, b)
        pick = (lambda o: o[0]) if factor else (lambda o: o)
        out = {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                got = pick(fn(D, U, b))
            out[side] = cs.hold_solve("%s_%s" % (name, side), got, pick(p32),
                                      pick(ref), random=False)
        return out

    # the systems
    task, start, goal = cs.bench_problem("cuda", cs.B)
    theta0 = straight_line_trajs(start, goal, cs.H)
    b14, D14, U14, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**cs.GP_PARAMS))
    pm_task, pm_params, pm_start, pm_goal, pm_theta0 = cs.pm_problem("cuda")
    b4, D4, U4, _ = _lanes_gn_system(
        pm_task.collision_residuals.obstacle_terms_lanes, pm_theta0,
        pm_start, pm_goal, pm_params)
    ru = cs.ru_problem()
    ru_task, ru_start, ru_goal, ru_theta0 = ru
    bf, Df, Uf, _ = _lanes_gn_system(
        ru_task.collision_residuals.obstacle_terms_lanes, ru_theta0,
        ru_start, ru_goal, GPMP2Params(**cs.RU_GP))

    # kernels alone
    for name, fn, (D, U, b), iters in (
            ("k2_m14", bk.solve_lanes_w, (D14, U14, b14), 20),
            ("k2_m4", bk.solve_lanes_w, (D4, U4, b4), 50),
            ("k9_factor_m14", bk.solve_lanes_factor, (Df, Uf, bf), 20)):
        errs = hold(name, fn, D, U, b, factor=name.startswith("k9"))
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(lambda: fn(D, U, b), iters=iters))
        extra = {}
        if name.startswith("k9"):
            lib_f, _ = cs.dense_cholesky_fns(D, U, b)
            extra["dense_cholesky_ms"] = cs.cuda_ms(lib_f, iters=3, warmup=1)
        elif name == "k2_m4":
            extra["dense_solve_ms"] = cs.cuda_ms(cs.dense_solve_fn(D, U, b),
                                                 iters=3, warmup=1)
        emit(name, shape=list(D.shape), other_ms=other_ms, this_ms=this_ms,
             speedup=other_ms / this_ms, turns_ms=turns, vs_float64=errs,
             **extra)
        torch.cuda.empty_cache()

    # K9's substitution on the factors of the same system and a fresh b:
    # each side held to float64 (the float64 substitution from the same
    # factors, and the float64 solve of the original system), the sides'
    # bits compared, in turns; this tree's at 2, 4 and 8 lanes a block and
    # with L and W kept on chip, whose bits must be its launch's own
    x, L, W = bk.solve_lanes_factor(Df, Uf, bf)
    b2 = torch.as_tensor(np.random.default_rng(11).normal(size=bf.shape)
                         * float(bf.abs().max()), dtype=torch.float32,
                         device="cuda")
    ref_s = solve_lanes_subst_core(L.double(), W.double(), b2.double())
    ref_x = solve_lanes_core(Df.double(), Uf.double(), b2.double())
    p32 = solve_lanes_subst_core(L, W, b2)
    _, Lp, Wp = solve_lanes_factor_core(Df, Uf, bf)
    outs, errs = {}, {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            outs[side] = bk.solve_lanes_subst(L, W, b2)
        errs[side] = dict(
            vs_subst_f64=cs.hold_solve("k9_subst_%s" % side, outs[side], p32,
                                       ref_s, random=False),
            vs_original_system=cs.hold_solve(
                "k9_subst_system_%s" % side, outs[side],
                solve_lanes_subst_core(Lp, Wp, b2), ref_x, random=False))
    other_ms, this_ms, turns = in_turns(
        swap, lambda: cs.device_ms(lambda: bk.solve_lanes_subst(L, W, b2),
                                   iters=20))
    H_, m_, _, B_ = L.shape
    variants = {}
    for rep in (1, 4, 16):               # B = 256, 1024, 4096: lanes repeated
        Lr, Wr, br = (t.repeat(*([1] * (t.dim() - 1)), rep)
                      for t in (L, W, b2))
        ref_r = outs["this"].repeat(1, 1, rep)
        for lanes in (2, 4, 8):
            for keep in (False, True):
                if 4 * lanes * (H_ * m_ + (H_ if keep else bk._SUBST_STAGES)
                                * (2 * m_ * m_ + m_)) > bk._SMEM_MAX:
                    continue                    # the block does not fit
                cfg = dict(lanes_per_block=lanes, keep_lw=keep)

                def run():
                    return bk._launch_subst(Lr, Wr, br, torch.empty_like(br),
                                            cfg)
                variants["B%d_lanes%d%s" % (B_ * rep, lanes,
                                            "_keep_lw" if keep else "")] = \
                    dict(ms=cs.device_ms(run, iters=20),
                         bit_for_bit=bool(torch.equal(run(), ref_r)))
        variants["B%d_default" % (B_ * rep)] = bk.subst_launch_config(
            m_, B_ * rep, H_)
        del Lr, Wr, br, ref_r
        torch.cuda.empty_cache()
    emit("k9_subst_m14", shape=list(L.shape), other_ms=other_ms,
         this_ms=this_ms, speedup=other_ms / this_ms, turns_ms=turns,
         bit_for_bit=bool(torch.equal(outs["other"], outs["this"])),
         max_abs_diff=float((outs["other"] - outs["this"]).abs().max()),
         vs_float64=errs, launch=bk.subst_launch_config(m_, B_, H_),
         this_tree_variants=variants,
         this_factor_ms=cs.device_ms(lambda: bk.solve_lanes_factor(Df, Uf, bf),
                                     iters=20),
         bound_ms=cs.bound_ms(*cs.subst_work(H_, m_, B_))[0])
    if not all(v["bit_for_bit"] for v in variants.values()
               if "bit_for_bit" in v):
        cs.fail("the substitution's bits change with its launch: %s"
                % variants)

    # the kernels this change leaves alone, bit for bit on the same inputs
    # (K3, whose one-thread kernel an older tree has, is reported only)
    same = {}
    with swap:
        k3_other = [bk.solve_lanes_sweep(D14, U14, b14, bwd_trsv=t)
                    for t in (False, True)]
        k2_other = bk.solve_lanes_w(D14, U14, b14)
        fac_other = bk.solve_lanes_factor(Df, Uf, bf)
    same["k2_m14"] = bool(torch.equal(k2_other,
                                      bk.solve_lanes_w(D14, U14, b14)))
    same["k9_factor"] = all(torch.equal(a, b) for a, b in zip(
        fac_other, bk.solve_lanes_factor(Df, Uf, bf)))
    k3_same = {"k3_%s" % ("trsv" if t else "trsm"): bool(torch.equal(
        xo, bk.solve_lanes_sweep(D14, U14, b14, bwd_trsv=t)))
        for t, xo in zip((False, True), k3_other)}
    emit("unchanged_kernels_bit_for_bit", **same, **k3_same)
    if not all(same.values()):
        cs.fail("a kernel this change leaves alone differs: %s" % same)

    # the main path
    cs.run_mpc(task, start, goal, 1)
    with swap:
        cs.run_mpc(task, start, goal, 1)

    def step_ms():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        cs.run_mpc(task, start, goal, cs.N_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / cs.N_STEPS
    other_ms, this_ms, turns = in_turns(swap, step_ms)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(
                lambda: cs.run_mpc(task, start, goal, 2), 2)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_step=dev_ms,
                          top_device_ms_per_step=top)
    emit("main_path_step", B=cs.B, H=cs.H, steps=cs.N_STEPS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, solves_per_s={"other": cs.B / (other_ms / 1e3),
                                       "this": cs.B / (this_ms / 1e3)},
         profile=prof)

    # the reuse workload
    for k in cs.RU_KS:
        p = GPMP2Params(**cs.RU_GP, refactor_every=k)
        fn = lambda: gpmp2_solve(ru_task.collision_residuals, ru_theta0,
                                 ru_start, ru_goal, p)
        fn()
        with swap:
            fn()
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(fn, iters=1, warmup=0) / cs.RU_ITERS)
        prof = {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                busy, dev_ms, top = cs.profile_device(fn, cs.RU_ITERS)
            prof[side] = dict(profiled_device_busy_share=busy,
                              profiled_device_ms_per_iteration=dev_ms,
                              top_device_ms_per_iteration=top)
        emit("reuse_k%d" % k, ms_per_iteration={"other": other_ms,
                                                 "this": this_ms},
             speedup=other_ms / this_ms, turns_ms=turns, profile=prof)



def ab_cols(swap, emit):
    """K4 on the GN and a random system (bits, float64, turns), this tree's
    K4 at one and two lanes a block, phase mr_mpc's ms per step (and a
    profile per side)."""
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system

    task, start, goal, _ = cs.mr_problem("cuda")
    theta0 = straight_line_trajs(start, goal, cs.MR_H)
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**cs.MR_GP))
    m = D_l.shape[1]
    for name, (D, U, b), random in (
            ("k4_gn", (D_l, U_l, b_l), False),
            ("k4_random", cs.random_system(cs.MR_H, m, cs.MR_B, seed=8),
             True)):
        x_p = solve_lanes_core(D, U, b)
        x_64 = solve_lanes_core(D.double(), U.double(), b.double())
        xs, errs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                xs[side] = bk.solve_lanes_cols(D, U, b)
            errs[side] = cs.hold_solve("%s_%s" % (name, side), xs[side],
                                       x_p, x_64, random=random)
        same = bool(torch.equal(xs["other"], xs["this"]))
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(lambda: bk.solve_lanes_cols(D, U, b),
                                     iters=20))
        by_lanes = {n: cs.cuda_ms(lambda: bk._launch_cols(D, U, b, n),
                                  iters=20) for n in (1, 2)}
        emit(name, shape=list(D.shape), bit_for_bit=same,
             max_abs_diff=float((xs["other"] - xs["this"]).abs().max()),
             other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
             turns_ms=turns, this_ms_by_lanes_per_block=by_lanes,
             launch=bk.cols_launch_config(m, D.shape[3]),
             bound_ms=cs.bound_ms(*cs.cols_solve_work(*D.shape[:2],
                                                      D.shape[3])),
             vs_float64=errs)
        torch.cuda.empty_cache()

    # one lane's chain: this tree's K4 at a few batches (one lane an SM at
    # B <= 132)
    by_batch = {}
    for Bn in (8, 132, cs.MR_B):
        Dn, Un, bn = cs.random_system(cs.MR_H, m, Bn, seed=8)
        by_batch[Bn] = cs.cuda_ms(lambda: bk.solve_lanes_cols(Dn, Un, bn),
                                  iters=20)
    emit("k4_this_by_batch", H=cs.MR_H, m=m, ms=by_batch)

    def events_ms():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        cs.mr_rollout(task, start, goal, cs.MR_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / cs.MR_STEPS
    cs.mr_rollout(task, start, goal, 1)
    with swap:
        cs.mr_rollout(task, start, goal, 1)
    other_ms, this_ms, turns = in_turns(swap, events_ms)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(
                lambda: cs.mr_rollout(task, start, goal, 2), 2)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_step=dev_ms,
                          top_device_ms_per_step=top)
    emit("mr_mpc_step", B=cs.MR_B, H=cs.MR_H, steps=cs.MR_STEPS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, solves_per_s={"other": cs.MR_B / (other_ms / 1e3),
                                       "this": cs.MR_B / (this_ms / 1e3)},
         profile=prof)


def ab_cols_wide(swap, other, emit):
    """K4's shared-memory route on five Pandas' first GN system and on
    random systems at m = 96, 112 and 128 (each side held to float64, the
    sides' difference, turns over a CUDA graph, the bound), both sides'
    ptxas, five Pandas' MPC step in turns with a profile per side."""
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system

    emit("cols_wide_ptxas",
         this=ptxas_report(bk.COLS_WIDE_KERNEL, "btridiag_cols_wide_kernel"),
         other=ptxas_report(other, "btridiag_cols_wide_kernel"))
    task, start, goal, _ = cs.mr_problem(
        "cuda", task=cs.mr_task("cuda", *cs.MR_CELLS["mr_five"]))
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes,
        straight_line_trajs(start, goal, cs.MR_H), start, goal,
        GPMP2Params(**cs.MR_GP))
    cases = [("mr_five_gn", lambda: (D_l, U_l, b_l), False)] + [
        ("random_m%d" % m, lambda m=m, i=i: cs.random_wide_system(
            cs.MR_H, m, cs.CW_B, seed=cs.SEED + 70 + i), True)
        for i, m in enumerate(cs.CW_M)]
    for name, make, random in cases:
        D, U, b = make()
        H, m, _, B = D.shape
        x_p = solve_lanes_core(D, U, b)
        x_64 = solve_lanes_core(D.double(), U.double(), b.double())
        xs, errs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                xs[side] = bk.solve_lanes_cols_wide(D, U, b)
            errs[side] = cs.hold_solve("%s_%s" % (name, side), xs[side],
                                       x_p, x_64, random=random)
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.device_ms(
                lambda: bk.solve_lanes_cols_wide(D, U, b), iters=5))
        emit(name, shape=list(D.shape),
             bit_for_bit=bool(torch.equal(xs["other"], xs["this"])),
             max_abs_diff=float((xs["other"] - xs["this"]).abs().max()),
             other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
             turns_ms=turns, launch=bk.cols_launch_config(m, B),
             bound_ms=cs.bound_ms(*cs.cols_solve_work(H, m, B)),
             vs_float64=errs)
        del D, U, b, x_p, x_64, xs
        torch.cuda.empty_cache()

    def events_ms():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        cs.mr_rollout(task, start, goal, cs.MR_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / cs.MR_STEPS
    cs.mr_rollout(task, start, goal, 1)
    with swap:
        cs.mr_rollout(task, start, goal, 1)
    other_ms, this_ms, turns = in_turns(swap, events_ms)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(
                lambda: cs.mr_rollout(task, start, goal, 2), 2)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_step=dev_ms,
                          top_device_ms_per_step=top)
    emit("mr_five_mpc_step", B=cs.MR_B, H=cs.MR_H, steps=cs.MR_STEPS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, solves_per_s={"other": cs.MR_B / (other_ms / 1e3),
                                       "this": cs.MR_B / (this_ms / 1e3)},
         profile=prof)


def ab_terms(other, emit):
    """K5 on phase mr_terms' four cases, on mr_grasp's and on mr_grid's
    first q (each side held to plain, the sides' bits, turns, bound); both
    sides' ptxas; K1 and K8 (both branches) bit for bit; config 4's MPC
    step in turns with a profile per side."""
    import numpy as np
    import torch
    from torch_robotics_tpu_torch.ops import terms_kernel as tk

    emit("ptxas", **{side: {
        "mr_terms_kernel": ptxas_report(mk, "mr_terms_kernel"),
        "terms_kernel": [x for x in ptxas_report(k1, "terms_kernel")
                         if "mr_terms" not in x]}
        for side, k1, mk in (("other", other[0], other[1]),
                             ("this", tk.KERNEL, tk.MR_KERNEL))})
    mr, mr_start, mr_goal, _ = cs.mr_problem("cuda")
    gmr, g_start, g_goal, _ = cs.mr_problem("cuda", grasp=True)
    env, _ = cs.grid_env()
    rmr = cs.mr_task("cuda", env=env)
    tight = cs.mr_task("cuda", cs.MR_TIGHT_POSES)
    two_arm = cs.mr_task("cuda", cs.MR_TWO_ARM_POSES)
    swap = terms_swap(*other, (mr, gmr, rmr, tight, two_arm))
    rng = np.random.default_rng(7)

    def in_limits(t, n):
        lo, hi = t.robot.q_min.cpu().numpy(), t.robot.q_max.cpu().numpy()
        u = rng.uniform(size=(lo.shape[0], n))
        return torch.as_tensor(lo[:, None] + u * (hi - lo)[:, None],
                               dtype=torch.float32, device="cuda")

    q_main = cs.mr_first_q(mr_start, mr_goal)
    N = q_main.shape[1]
    cases = (("k5_config4_first_q", mr, q_main),
             ("k5_config4_random_q", mr, in_limits(mr, N)),
             ("k5_tight_poses_random_q", tight, in_limits(tight, N)),
             ("k5_two_arm_random_q_N4096", two_arm, in_limits(two_arm, 4096)),
             ("k5_grasped_first_q", gmr, cs.mr_first_q(g_start, g_goal)),
             ("k5_grid_first_q", rmr, q_main))
    for name, t, q in cases:
        hook = t.collision_residuals.obstacle_terms_lanes
        ref = hook.plain.unscaled(q)
        grid = hook.grid is not None
        near = cs.object_points_near_face(t, q) if grid else None
        outs, errs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                outs[side] = [o.clone() for o in hook.unscaled(q)]
            if grid:
                errs[side] = cs.hold_grid("%s_%s" % (name, side), outs[side],
                                          ref, near)
            else:
                res = {}
                cs.hold_terms("%s_%s" % (name, side), outs[side], ref, res)
                errs[side] = {"abs": res[name + "_" + side][0],
                              "rel_to_max": res[name + "_" + side][1]}
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.device_ms(lambda: hook.unscaled(q), iters=20))
        other_call, this_call, _ = in_turns(
            swap, lambda: cs.cuda_ms(lambda: hook.unscaled(q), iters=50))
        r = hook.plain.rows(q)[0]
        work = cs.mr_terms_work(hook.plain.layout, q, r)
        differ = torch.zeros(q.shape[1], dtype=torch.bool, device="cuda")
        for a, b in zip(outs["other"], outs["this"]):
            differ |= (a != b).reshape(-1, a.shape[-1]).any(0)
        emit(name, N=q.shape[1], bit_for_bit=not bool(differ.any()),
            lanes_differing=int(differ.sum()),
            max_abs_diff=max(float((a - b).abs().max()) for a, b in zip(
                outs["other"], outs["this"])),
            vs_plain=errs, other_ms=other_ms, this_ms=this_ms,
            speedup=other_ms / this_ms, turns_ms=turns,
            call_ms={"other": other_call, "this": this_call},
            bound_ms=cs.bound_ms(*work)[0], launch=hook.params[4],
            active_row_share=float((r > 0).float().mean()))
        torch.cuda.empty_cache()

    # K1 (pair field, grasped, grid) and K8, bit for bit: their kernels'
    # arithmetic is meant to stay as it is; K1's time in turns
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task, start, goal = cs.bench_problem("cuda", cs.B)
    gtask = cs.grasp_task("cuda")
    rtask = PlanningTask(env=env, robot=RobotPanda.create(device="cuda"),
                         obstacle_cutoff_margin=cs.GRID_CUTOFF)
    same, k1_ms = {}, {}
    q_r = cs.random_q(task, 79360, seed=2)
    for name, fn, q in (
            ("k1", task.collision_residuals.obstacle_terms_lanes.unscaled,
             cs.random_q(task, cs.H * cs.B, seed=1)),
            ("k1_grasped",
             gtask.collision_residuals.obstacle_terms_lanes.unscaled,
             cs.random_q(gtask, cs.H * cs.B, seed=3)),
            ("k1_grid", rtask.collision_residuals.obstacle_terms_lanes.unscaled,
             cs.random_q(rtask, cs.H * cs.B, seed=4)),
            ("k8", task.collision_residuals.collision_cost_lanes, q_r),
            ("k8_multirobot", mr.collision_residuals.collision_cost_lanes,
             q_main)):
        with swap:
            o = fn(q)
        o = o if isinstance(o, tuple) else (o,)
        t_ = fn(q)
        same[name] = all(torch.equal(a, b) for a, b in zip(
            o, t_ if isinstance(t_, tuple) else (t_,)))
        if name.startswith("k1"):
            other_ms, this_ms, turns = in_turns(
                swap, lambda: cs.device_ms(lambda: fn(q), iters=20))
            k1_ms[name] = dict(N=q.shape[1], other_ms=other_ms,
                               this_ms=this_ms, speedup=other_ms / this_ms,
                               turns_ms=turns)
    emit("unchanged_kernels_bit_for_bit", **same)
    emit("k1_in_turns", **k1_ms)
    if not all(same.values()):
        cs.fail("a kernel this change leaves alone differs: %s" % same)

    # config 4's MPC step in turns, a profile per side
    def events_ms():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        cs.mr_rollout(mr, mr_start, mr_goal, cs.MR_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / cs.MR_STEPS
    cs.mr_rollout(mr, mr_start, mr_goal, 1)
    with swap:
        cs.mr_rollout(mr, mr_start, mr_goal, 1)
    other_ms, this_ms, turns = in_turns(swap, events_ms)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(
                lambda: cs.mr_rollout(mr, mr_start, mr_goal, 2), 2)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_step=dev_ms,
                          top_device_ms_per_step=top)
    emit("mr_mpc_step", B=cs.MR_B, H=cs.MR_H, steps=cs.MR_STEPS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, profile=prof)


def ab_net(other, routed, emit):
    """The K1 row at 65,536 (three nets) and the K8 row at 2,097,152 and
    131,072 (two nets), each side held to plain, in turns, with both
    bounds; the net sGPMP iteration and the net main path's step in turns
    with a profile per side."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.ops import net_kernel as nk
    from torch_robotics_tpu_torch.solve import SGPMPParams, sgpmp_solve

    def ptxas(kernel):
        lines = kernel.library_path.with_suffix(".log").read_text() \
            .splitlines()
        return {line.split("'")[1]: " | ".join(
            x.strip().split("info    : ")[-1] for x in lines[i + 1:i + 4])
            for i, line in enumerate(lines)
            if "Compiling entry function" in line}
    emit("ptxas", other=ptxas(other), this=ptxas(nk.NET_TERMS_KERNEL))

    task_b, start, goal = cs.bench_problem("cuda", cs.B,
                                           robot=cs.net_robot("cuda"))
    q = cs.net_first_q(start, goal)
    tasks = {"bundled": task_b, **{
        act + "_spread": cs.net_task("cuda", cs.net_spread_arrays(act, q))
        for act in ("relu", "tanh")}}
    il_task, il_start, il_goal = cs.ilqr_problem("cuda")
    sg_b = cs.net_task("cuda", cutoff=0.06)
    problem = cs.sg_problem(il_start, il_goal, cs.SG_PART, cs.IL_H,
                            cs.SG_PARAMS["dt"], cs.SEED + 2)
    seen = cs.capture_cost_inputs(sg_b, *problem, cs.SG_PARAMS)
    q_prop = seen[cs.IL_B * cs.SG_PART * cs.IL_H]
    cost_tasks = {"bundled": sg_b, "relu_spread": cs.net_task(
        "cuda", cs.net_spread_arrays("relu", q_prop), cutoff=0.06)}
    rows = [t.collision_residuals.obstacle_terms_lanes.net_row
            for t in (*tasks.values(), *cost_tasks.values())]
    swap = net_swap(other, routed, rows)

    def zeros(N):
        return (torch.zeros((7, N), device="cuda"),
                torch.zeros((7, 7, N), device="cuda"),
                torch.zeros((N,), device="cuda"))

    def held(name, fn, ref, keep):
        errs = {}
        for side in ("other", "this"):
            got = tuple(torch.zeros_like(r) for r in ref)
            with (swap if side == "other" else _null()):
                fn(*got)
            errs[side] = cs.hold_lanes("%s_%s" % (name, side), got, ref,
                                       keep)
        return {k: {"abs": v[0], "rel_to_max": v[1]} for k, v in errs.items()}

    for kind, task in tasks.items():
        row = task.collision_residuals.obstacle_terms_lanes.net_row
        net = row.net
        keep, n_edge = cs.net_keep_lanes(kind, net, q)
        N = q.shape[1]
        ref = zeros(N)
        nk.net_terms_plain(net, q, cs.NET_CUTOFF, *ref)
        errs = held("k1_row_" + kind,
                    lambda *out: nk.add_net_terms(row, q, *out), ref, keep)
        bufs = zeros(N)
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(lambda: nk.add_net_terms(row, q, *bufs),
                                     iters=20))
        work = cs.net_row_work(net, N, int((ref[2] > 0).sum()), True)
        emit("k1_row_" + kind, N=N, route=row.launch["route"],
             vs_plain=errs, excluded_lanes=n_edge, other_ms=other_ms,
             this_ms=this_ms, speedup=other_ms / this_ms, turns_ms=turns,
             bound_ms=cs.bound_ms(*work)[0],
             bound_ms_tf32x3=cs.bound_ms(*work, cs.PEAK_TF32X3_FLOPS)[0])
        torch.cuda.empty_cache()

    for kind, task in cost_tasks.items():
        row = task.collision_residuals.obstacle_terms_lanes.net_row
        net = row.net
        for N, qq in sorted(seen.items()):
            keep, n_edge = cs.net_keep_lanes(kind, net, qq)
            ref = torch.zeros(N, device="cuda")
            nk.net_cost_plain(net, qq, cs.NET_CUTOFF, ref)
            errs = held("k8_row_%s_N%d" % (kind, N),
                        lambda out: nk.add_net_cost(row, qq, out), (ref,),
                        keep)
            buf = torch.zeros(N, device="cuda")
            other_ms, this_ms, turns = in_turns(
                swap, lambda: cs.cuda_ms(lambda: nk.add_net_cost(row, qq, buf),
                                         iters=10))
            work = cs.net_row_work(net, N, int((ref > 0).sum()), False)
            emit("k8_row_%s_N%d" % (kind, N), N=N, route=row.launch["route"],
                 vs_plain=errs, excluded_lanes=n_edge, other_ms=other_ms,
                 this_ms=this_ms, speedup=other_ms / this_ms, turns_ms=turns,
                 bound_ms=cs.bound_ms(*work)[0],
                 bound_ms_tf32x3=cs.bound_ms(*work,
                                             cs.PEAK_TF32X3_FLOPS)[0])
            torch.cuda.empty_cache()

    def net_ms(top):
        return sum(v for k, v in top.items()
                   if any(n in k for n in cs.NET_ROW_KERNELS))

    p = SGPMPParams(**dict(cs.SG_PARAMS, opt_iters=10))

    def solve(n_iter=p.opt_iters):
        return sgpmp_solve(
            sg_b.collision_residuals, *problem,
            dataclasses.replace(p, opt_iters=n_iter),
            generator=torch.Generator(device="cuda").manual_seed(7))
    solve(2)
    with swap:
        solve(2)
    other_ms, this_ms, turns = in_turns(
        swap, lambda: cs.cuda_ms(solve, iters=1, warmup=0) / p.opt_iters)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(lambda: solve(5), 5)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_iteration=dev_ms,
                          net_row_device_ms_per_iteration=net_ms(top),
                          top_device_ms_per_iteration=top)
    emit("net_sgpmp_iteration", B=cs.IL_B, iterations=p.opt_iters,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, profile=prof)
    torch.cuda.empty_cache()

    task = tasks["relu_spread"]
    cs.run_mpc(task, start, goal, 1)
    with swap:
        cs.run_mpc(task, start, goal, 1)
    other_ms, this_ms, turns = in_turns(
        swap, lambda: cs.cuda_ms(
            lambda: cs.run_mpc(task, start, goal, cs.N_STEPS), iters=1,
            warmup=0) / cs.N_STEPS)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(
                lambda: cs.run_mpc(task, start, goal, 2), 2, n_top=10)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_step=dev_ms,
                          net_row_device_ms_per_step=net_ms(top),
                          top_device_ms_per_step=top)
    emit("net_main_step", B=cs.B, H=cs.H, steps=cs.N_STEPS, net="relu_spread",
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, profile=prof)


# the stage cuts of ``--kernels cost``: lines of cost.cu (this design's
# and the one before it, at any indentation) after which a copy of the
# kernel stops, and the stages
STAGE_FK = "const int first_off = i1.y - i1.z;"
STAGE_ROWS = "const int end = a.cuts[t + 1];"
STAGES = ("fk", "fk_points", "object_rows", "workspace_rows")
# rounds of turns of the sGPMP iteration: two alternating pairs a round
SG_ROUNDS = 25


def staged_cost_source(src: str, k: int) -> str:
    """cost.cu cut after stage STAGES[k]: 0, each member's FK chain with
    no points written (its last transform kept live in one word); 1, FK
    and the points; 2, and the object SDF rows; 3, and the workspace rows
    (the whole kernel adds the pair rows).  A cut kernel's cost is not
    the cost."""
    lines = src.split("\n")
    at = {a: [i for i, line in enumerate(lines) if line.strip() == a]
          for a in (STAGE_FK, STAGE_ROWS)}
    if any(len(v) != 1 for v in at.values()):
        cs.fail("cost.cu has no stage anchors")
    i_fk, i_rows = at[STAGE_FK][0], at[STAGE_ROWS][0]
    pad = lines[i_rows][:len(lines[i_rows]) - len(lines[i_rows].lstrip())]
    end = ("a.cuts[t]", "a.cuts[t]", "min(a.cuts[t + 1], n_sdf)",
           "min(a.cuts[t + 1], n_sdf + a.NO)")[k]
    lines[i_rows] = pad + "const int end = %s;" % end + (
        "\n%scacc = pts[lane];" % pad if k <= 1 else "")
    if k == 0:
        p = lines[i_fk][:len(lines[i_fk]) - len(lines[i_fk].lstrip())]
        lines[i_fk] = ("%sif (s == a.mem_step[t + 1] - 1)\n%s  pts[lane] = "
                       "tv[0] + tv[1] + tv[2] + R[0] + R[4] + R[8];\n"
                       "%scontinue;\n" % (p, p, p)) + lines[i_fk]
    return "\n".join(lines)


def cost_stage_kernels(csrc: Path, side: str):
    """Copies of ``csrc``'s cost.cu cut after each of STAGES, with its
    headers, in a directory of the build tree of their own."""
    import shutil

    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    from torch_robotics_tpu_torch.ops.cuda_build import BUILD_DIR
    OtherKernel = other_kernel_class()
    d = BUILD_DIR / ("stages-%s" % side)
    d.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    src = (csrc / "cost.cu").read_text()
    kernels = []
    for k, stage in enumerate(STAGES):
        f = d / ("cost_%s.cu" % stage)
        f.write_text(staged_cost_source(src, k))
        kernels.append(OtherKernel(str(f), dict(tk.COST_KERNEL.functions)))
    return kernels


def cost_swap(kernel):
    """``kernel`` (a cost.cu library) in place of this tree's K8 in both
    branches, under this tree's wrappers and packing."""
    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    return Swap(tk, ("COST_KERNEL", "MR_COST_KERNEL"),
                lambda name, args: (kernel, args))


def frames_task():
    """The iLQR Panda with each joint's fixed rotation replaced by a seeded
    random rotation: no product of its FK is exact, so the order in which
    cost.cu's axis classes contract their two remaining terms decides the
    bits (the zoo robots' fixed rotations are signed permutations up to
    rounding, which hides it)."""
    import dataclasses

    import numpy as np
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    robot = RobotPanda.create(device="cuda")
    rng = np.random.default_rng(17)
    rots = []
    for _ in range(robot.model.n_links):
        qr, rr = np.linalg.qr(rng.normal(size=(3, 3)))
        qr = qr * np.sign(np.diag(rr))
        rots.append(qr * np.linalg.det(qr))
    model = dataclasses.replace(robot.model, joint_fixed_rot=np.asarray(
        rots, np.float32))
    return PlanningTask(env=EnvSpheres3D(device="cuda"),
                        robot=dataclasses.replace(robot, model=model),
                        obstacle_cutoff_margin=0.06)


def cost_cases():
    """[(case, task, q, MultiRobot)] of phases cost, grid_cost,
    grasp_cost, mr_cost, mr_grid and mr_grasp (and ``frames_task`` at the
    line search's N): a single robot at the iLQR
    line search's 79,360 (the path's first q for the Panda, random q as
    the grid and grasped phases take), the sGPMP acceptance's 131,072 and
    candidates' 2,097,152; config 4 at the acceptance's 8,192 and the
    candidates' 131,072."""
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task, start, goal = cs.ilqr_problem("cuda")
    env, _ = cs.grid_env()
    singles = {
        "panda": (task, cs.capture_first_iteration(task, start, goal)),
        "grid": (PlanningTask(env=env, robot=RobotPanda.create(device="cuda"),
                              obstacle_cutoff_margin=0.06), 22),
        "grasped": (cs.grasp_task("cuda", cutoff=0.06), 32)}
    N_ls = len(cs.IL_ALPHAS) * cs.IL_B * (cs.IL_H - 1)
    cases = [("panda_random_frames", frames_task(),
              cs.random_q(task, N_ls, seed=23), False)]
    for name, (t, src) in singles.items():
        q_ls = (src["cost_%d" % N_ls] if isinstance(src, dict)
                else cs.random_q(t, N_ls, seed=src))
        seen = cs.capture_cost_inputs(t, *cs.sg_problem(
            start, goal, cs.SG_PART, cs.IL_H, cs.SG_PARAMS["dt"],
            cs.SEED + 2), cs.SG_PARAMS)
        cases += [(name, t, q, False) for q in [q_ls] + [
            seen[n] for n in sorted(seen)]]
    mr, mr_start, mr_goal, _ = cs.mr_problem("cuda")
    gmr, g_start, g_goal, _ = cs.mr_problem("cuda", grasp=True)
    for name, t, s0, g0 in (("config4", mr, mr_start, mr_goal),
                            ("config4_grid", cs.mr_task("cuda", env=env),
                             mr_start, mr_goal),
                            ("config4_grasped", gmr, g_start, g_goal)):
        seen = cs.capture_cost_inputs(t, *cs.sg_problem(
            s0, g0, 1, cs.MR_H, cs.MR_GP["dt"], cs.SEED + 3),
            cs.MR_SG_PARAMS)
        cases += [(name, t, seen[n], True) for n in sorted(seen)]
    return cases, dict(panda=(task, start, goal),
                       grasped_config4=(gmr, g_start, g_goal), **{
                           k: (singles[k][0], start, goal)
                           for k in ("grid", "grasped")})


def ab_cost(other, stages, emit):
    """K8 (cost.cu, both branches) on every branch and shape of the cost
    phases: each side held to the plain version, the lanes where the sides
    differ, the device time in turns over a CUDA graph, the bound; both
    sides' ptxas; each side's stage cuts at the candidates' N in turns; the
    sGPMP iteration of the Panda, the grid and the grasped Panda and
    grasped config 4 in alternating pairs (``paired_wall``), with a
    profile per side."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.geom import GridSDF
    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.solve import SGPMPParams, sgpmp_solve

    emit("ptxas", **{side: ptxas_report(k, "cost_kernel")
                     for side, k in (("other", other),
                                     ("this", tk.COST_KERNEL))})
    swap = cost_swap(other)
    cases, paths = cost_cases()
    for name, task, q, multi in cases:
        N = q.shape[1]
        key = "k8_%s_N%d" % (name, N)
        cost = task.collision_residuals.collision_cost_lanes
        lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
        grid = any(isinstance(o, GridSDF) for o in lay.df_obj_list)
        ref = (cs.chunked(cost.plain, q) if N > 1 << 20 and not grid
               else cost.plain(q))
        near = cs.object_points_near_face(task, q) if grid else None
        outs, errs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                outs[side] = cost(q).clone()
            if grid:
                errs[side] = cs.hold_grid("%s_%s" % (key, side),
                                          (outs[side],), (ref,), near)
            else:
                e = cs.hold_cost("%s_%s" % (key, side), outs[side], ref)
                errs[side] = {"abs": e[0], "rel_to_max": e[1]}
        differ = outs["other"] != outs["this"]
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.device_ms(lambda: cost(q), iters=20))
        n_rows = (len(lay.obj_pos) * (2 if lay.df_obj_list else 1)
                  + len(lay.pair_a))
        work = (cs.mr_cost_work(lay, N, n_rows) if multi else
                cs.cost_work(TermsLayout(task), N, n_rows))
        emit(key, N=N, lanes_differing=int(differ.sum()),
             max_abs_diff=float((outs["other"] - outs["this"]).abs().max()),
             vs_plain=errs, other_ms=other_ms, this_ms=this_ms,
             speedup=other_ms / this_ms, turns_ms=turns,
             bound_ms=cs.bound_ms(*work)[0], launch=cost.params[3])
        if N == 2097152:
            # where the time goes: each side's stage cuts, in turns
            runs = [(side, stage, cost_swap(k)) for side in ("other", "this")
                    for stage, k in zip(STAGES + ("whole",), stages[side]
                                        + [None])]
            ms = {}
            for rnd in (0, 1):
                for side, stage, sw in (runs if rnd == 0 else runs[::-1]):
                    whole = (swap if side == "other" else _null())
                    with (sw if stage != "whole" else whole):
                        ms.setdefault("%s_%s" % (side, stage), []).append(
                            cs.device_ms(lambda: cost(q), iters=20))
            emit(key + "_stages", N=N, stages=STAGES + ("whole",),
                 ms={k: sum(v) / 2 for k, v in ms.items()})
        torch.cuda.empty_cache()

    # the sGPMP iteration in turns, a profile per side
    for name, (task, start, goal) in paths.items():
        multi = name == "grasped_config4"
        p = SGPMPParams(**dict(cs.MR_SG_PARAMS if multi else cs.SG_PARAMS,
                               opt_iters=20))
        seed = cs.SEED + (3 if multi else 2)
        problem = cs.sg_problem(start, goal, 1 if multi else cs.SG_PART,
                                p.n_support_points, p.dt, seed)

        def solve(n_iter=p.opt_iters, task=task, problem=problem, p=p,
                  seed=seed):
            return sgpmp_solve(
                task.collision_residuals, *problem,
                dataclasses.replace(p, opt_iters=n_iter),
                generator=torch.Generator(device="cuda").manual_seed(
                    seed + 1))
        solve(2)
        with swap:
            solve(2)
        # SG_ROUNDS rounds of turns, two alternating pairs a round: the
        # host's time per iteration spreads
        turns = []
        for _ in range(SG_ROUNDS):
            turns += in_turns(swap, lambda: cs.cuda_ms(
                solve, iters=1, warmup=0) / p.opt_iters)[2]
        wall = paired_wall(turns)
        prof = {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                busy, dev_ms, top = cs.profile_device(lambda: solve(5), 5,
                                                      n_top=12)
            prof[side] = dict(
                profiled_device_busy_share=busy,
                profiled_device_ms_per_iteration=dev_ms,
                k8_device_ms_per_iteration=sum(
                    v for k, v in top.items() if "cost_kernel" in k),
                top_device_ms_per_iteration=top)
        k8_saving = (prof["other"]["k8_device_ms_per_iteration"]
                     - prof["this"]["k8_device_ms_per_iteration"])
        emit("sgpmp_iteration_" + name, iterations=p.opt_iters,
             **wall, k8_device_saving_ms=k8_saving, turns_ms=turns,
             profile=prof)
        torch.cuda.empty_cache()


def paired_wall(turns):
    """Wall ms of rounds of turns (other, this, this, other, ...) read as
    alternating pairs (other, this), (this, other): each side's median and
    quartiles, the median and quartiles of this - other over the pairs,
    the share of pairs this tree's side wins, whether that is a gain (it
    wins at least nine tenths of the pairs and the medians differ by more
    than the other side's quartile spread), and whether this tree's side
    is not slower: "met" where this - other is below 0 in more than three
    quarters of the pairs, "not met" where it is above 0 in more than
    three quarters, else "unresolved"."""
    import numpy as np
    t = np.asarray(turns).reshape(-1, 4)
    other = np.concatenate([t[:, 0], t[:, 3]])
    this = np.concatenate([t[:, 1], t[:, 2]])
    diff = np.concatenate([t[:, 1] - t[:, 0], t[:, 2] - t[:, 3]])

    def quartiles(x):
        return [float(v) for v in np.percentile(x, (25, 50, 75))]
    q_diff = quartiles(diff)
    q_other, q_this = quartiles(other), quartiles(this)
    verdict = ("met" if q_diff[2] < 0 else
               "not met" if q_diff[0] > 0 else "unresolved")
    wins = float((diff < 0).mean())
    return dict(pairs=len(diff), other_ms=q_other[1], this_ms=q_this[1],
                speedup=q_other[1] / q_this[1], other_quartiles_ms=q_other,
                this_quartiles_ms=q_this, this_minus_other_quartiles_ms=q_diff,
                this_wins=wins, gain=bool(
                    wins >= 0.9 and q_other[1] - q_this[1] > q_other[2]
                    - q_other[0]), not_slower=verdict)


def ab_solvers(swap, kernels, sweeps, emit):
    """K3 (both tails) and K11 in turns with the other tree's: each side
    held to float64 (or, on a random system, to its plain version) as
    chip_smoke.hold_solve holds it, the sides' bits compared, the device
    time over a CUDA graph of calls in turns; K2 beside them, and K2 and
    K9's factor sweep bit for bit against the other tree's (``sweeps``,
    its btridiag.cu under ``sweep_swap``; reported).  The other side's
    K11 also per launch (``launch_breakdown``); both sides' ptxas for
    every K3 and K11 instantiation."""
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.solve import (GPMP2Params, solve_lanes_bcr,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    (k3, _), (cr, _) = kernels
    emit("solvers_ptxas", **{
        side: {frag: ptxas_report(k, frag) for k, frags in (
            (k3_k, ("btridiag_sweep_kernel", "btridiag_w_kernel")),
            (cr_k, ("cr_",))) for frag in frags}
        for side, k3_k, cr_k in (("other", k3, cr),
                                 ("this", bk.SWEEP_KERNEL, bk.CR_KERNEL))})

    task, start, goal = cs.bench_problem("cuda", cs.B)
    theta0 = straight_line_trajs(start, goal, cs.H)
    b14, D14, U14, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**cs.GP_PARAMS))
    pm_task, pm_params, pm_start, pm_goal, pm_theta0 = cs.pm_problem("cuda")
    b4, D4, U4, _ = _lanes_gn_system(
        pm_task.collision_residuals.obstacle_terms_lanes, pm_theta0,
        pm_start, pm_goal, pm_params)
    del task, pm_task
    with sweeps:
        k2_other = bk.solve_lanes_w(D14, U14, b14)
        fac_other = bk.solve_lanes_factor(D14, U14, b14)
    emit("k2_k9_factor_bits_of_other", k2=bool(torch.equal(
        k2_other, bk.solve_lanes_w(D14, U14, b14))),
         k9_factor=all(torch.equal(a, b) for a, b in zip(
             fac_other, bk.solve_lanes_factor(D14, U14, b14))))
    del k2_other, fac_other
    fns = {"sweep_trsm": lambda D, U, b: bk.solve_lanes_sweep(D, U, b),
           "sweep_trsv": lambda D, U, b: bk.solve_lanes_sweep(
               D, U, b, bwd_trsv=True),
           "cr": bk.solve_lanes_cr}
    k3_order = ("sweep_trsm", "sweep_trsv", "cr")
    cases = (("gn_H64_m14_B1024", lambda: (D14, U14, b14), False, k3_order),
             ("random_H64_m14_B1024",
              lambda: cs.random_system(cs.H, 14, cs.B, seed=14), True,
              k3_order),
             ("gn_H64_m4_B1024", lambda: (D4, U4, b4), False, k3_order),
             ("gn_H64_m14_B4096", lambda: tuple(
                 t.repeat(*([1] * (t.dim() - 1)), 4) if t.shape[-1] == cs.B
                 else t for t in (D14, U14, b14)), False, k3_order),
             ("random_H256_m14_B1024",
              lambda: cs.random_system(4 * cs.H, 14, cs.B, seed=16), True,
              ("cr",)))
    for name, make, random, order in cases:
        D, U, b = make()
        x_64 = solve_lanes_core(D.double(), U.double(), b.double())
        plain = {"sweep_trsm": solve_lanes_core(D, U, b)}
        plain["sweep_trsv"] = plain["sweep_trsm"]
        plain["cr"] = solve_lanes_bcr(D, U, b)
        k2 = bk.solve_lanes_w(D, U, b)
        res = {"k2": dict(ms=cs.device_ms(lambda: bk.solve_lanes_w(D, U, b),
                                          iters=10),
                          vs_float64=cs.hold_solve("k2_" + name, k2,
                                                   plain["sweep_trsm"], x_64,
                                                   random))}
        for k in order:
            outs = {}
            for side in ("other", "this"):
                with (swap if side == "other" else _null()):
                    outs[side] = fns[k](D, U, b)
            errs = {side: cs.hold_solve("%s_%s_%s" % (k, name, side), x,
                                        plain[k], x_64, random)
                    for side, x in outs.items()}
            other_ms, this_ms, turns = in_turns(
                swap, lambda: cs.device_ms(lambda: fns[k](D, U, b),
                                           iters=10))
            res[k] = dict(other_ms=other_ms, this_ms=this_ms,
                          speedup=other_ms / this_ms, turns_ms=turns,
                          vs_float64=errs,
                          bit_for_bit=bool(torch.equal(outs["other"],
                                                       outs["this"])),
                          max_abs_diff=float((outs["other"]
                                              - outs["this"]).abs().max()))
            if k == "sweep_trsm":
                res[k]["this_bits_of_k2"] = bool(torch.equal(outs["this"],
                                                             k2))
        bound = cs.bound_ms(*cs.solve_work(*D.shape[:2], D.shape[3]))[0]
        emit("solvers_" + name, shape=list(D.shape), bound_ms=bound, **res)
        del D, U, b, x_64, plain, k2
        torch.cuda.empty_cache()

    # where the time of each side's K11 goes, launch by launch
    per = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            per[side] = launch_breakdown(
                lambda: bk.solve_lanes_cr(D14, U14, b14))
    emit("cr_per_launch_gn_H64_m14_B1024", **{
        side: dict(launches=n, sum_us=sum(t for _, t in bd),
                   per_launch_us=bd) for side, (bd, n) in per.items()})

    # this tree's K11 at other launch shapes (a lane's bits do not depend
    # on them)
    ref = bk.solve_lanes_cr(D14, U14, b14)
    shapes = {}
    for lanes, threads in ((1, 32), (1, 64), (2, 32), (2, 64), (2, 128),
                           (4, 64), (4, 128), (4, 256), (8, 128), (8, 256)):
        cfg = bk.cr_launch_config(14, cs.B, cs.H, lanes, threads)
        run = lambda: bk._launch_cr(D14, U14, b14, cfg)
        shapes["lanes%d_threads%d" % (lanes, threads)] = dict(
            ms=cs.device_ms(run, iters=10),
            bit_for_bit=bool(torch.equal(run(), ref)))
    emit("cr_launch_shapes_gn_H64_m14_B1024",
         default=bk.cr_launch_config(14, cs.B, cs.H), shapes=shapes)


def ab_sdf(swaps, kernels, emit):
    """K10 and K12 in turns with the other tree's (see the module doc)."""
    import itertools

    import numpy as np
    import torch
    from torch_robotics_tpu_torch.ops import gn_assembly_kernel as gk
    from torch_robotics_tpu_torch.ops import sdf_kernel as sk
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    (sdf_swap, gn_swap), (sdf_other, gn_other) = swaps, kernels
    emit("sdf_gn_ptxas", **{side: {
        frag: ptxas_report(k, frag) for k, frag in (
            (sdf_k, "sphere_sdf_kernel"), (gn_k, "gn_assembly_kernel"))}
        for side, sdf_k, gn_k in (("other", sdf_other, gn_other),
                                  ("this", sk.KERNEL, gk.KERNEL))})
    emit("sdf_sass", **{side: cs.sdf_pair_instructions(k.library_path)
                        for side, k in (("other", sdf_other),
                                        ("this", sk.KERNEL))})
    emit("sdf_sass_listing", **{
        side: {n: ins for n, ins in cs.sass_functions(k.library_path).items()
               if "sphere_sdf_kernel" in n}
        for side, k in (("other", sdf_other), ("this", sk.KERNEL))})

    def same(a, b):
        a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(
            b) else b
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def turns(swap, name, fn, inputs, copies, work, iters):
        """Each side's outputs on inputs[0] (bit for bit, required) and its
        device time over a CUDA graph of ``iters`` calls rotating over
        ``copies`` input sets, in turns."""
        outs = {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                outs[side] = fn(*inputs)
        bits = same(outs["other"], outs["this"])
        cs.check(bits, "%s: this tree's outputs are not the other tree's "
                 "bits" % name)
        cycle = itertools.cycle(copies)
        other_ms, this_ms, t = in_turns(swap, lambda: cs.device_ms(
            lambda: fn(*next(cycle)), iters=iters))
        emit(name, other_ms=other_ms, this_ms=this_ms,
             speedup=other_ms / this_ms, turns_ms=t, bit_for_bit=bits,
             bound_ms=cs.bound_ms(*work)[0])
        return outs["this"]

    # K10 on phase point_cloud's cloud and queries, and the other cases
    rng = np.random.default_rng(12)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")
    pts = f32(rng.uniform(-1, 1, size=(cs.PC_M, 3)))
    c = f32(rng.uniform(-1, 1, size=(cs.PC_S, 3)))
    r = torch.full((cs.PC_S,), cs.PC_RADIUS, device="cuda")
    r_var = f32(rng.uniform(*cs.PC_RADII, size=cs.PC_S))
    c_odd = f32(rng.uniform(-1, 1, size=(cs.PC_ODD_S, 3)))
    r_odd = f32(rng.uniform(*cs.PC_RADII, size=cs.PC_ODD_S))
    c_wide = torch.cat([c, f32(rng.uniform(-1, 1, size=(16384 - cs.PC_S,
                                                         3)))])
    r_wide = torch.full((16384,), cs.PC_RADIUS, device="cuda")
    cases = [("M65536_S4096", (pts, c, r))]
    cases += [("M65536_S%d" % S_, (pts, c[:S_].contiguous(),
                                   r[:S_].contiguous()))
              for S_ in (129, 512)]
    cases += [("M65536_S16384", (pts, c_wide, r_wide)),
              ("radii_M65536_S4096", (pts, c, r_var)),
              ("radii_M65536_S%d" % cs.PC_ODD_S, (pts, c_odd, r_odd)),
              ("M%d_S4096" % cs.PC_RAGGED_M,
               (pts[:cs.PC_RAGGED_M].contiguous(), c, r))]
    for name, ins in cases:
        turns(sdf_swap, "sdf_" + name, sk.sphere_sdf_kernel, ins, [ins],
              cs.sdf_work(ins[0].shape[0], ins[1].shape[0]), iters=20)
    # this tree's K10 at other warps a block (a point's value does not
    # depend on them)
    ref = sk.sphere_sdf_kernel(pts, c, r)
    shapes = {}
    for warps in (4, 8, 16):
        def run(w=warps):
            out = torch.empty_like(ref)
            sk.KERNEL.launch("trt_sphere_sdf_launch", pts.data_ptr(),
                             c.data_ptr(), r.data_ptr(), out.data_ptr(),
                             cs.PC_M, cs.PC_S, w,
                             torch.cuda.current_stream().cuda_stream)
            return out
        shapes["warps%d" % warps] = dict(
            ms=cs.device_ms(run, iters=20),
            bit_for_bit=bool(torch.equal(run(), ref)))
    emit("sdf_warps_M65536_S4096",
         default=sk.sdf_launch_config(cs.PC_M, cs.PC_S), shapes=shapes)
    del pts, c, r, r_var, c_odd, r_odd, c_wide, r_wide, ref
    torch.cuda.empty_cache()

    # K12 on the main path's first (r, Jr), as phase solvers builds them
    task, start, goal = cs.bench_problem("cuda", cs.B)
    theta0 = straight_line_trajs(start, goal, cs.H)
    d = start.shape[1] // 2
    q = theta0[..., :d].permute(1, 0, 2).reshape(-1, d).contiguous()
    r_b, J_b = task.collision_residuals.residuals_and_jacobian(q)
    r_gn = r_b.T.contiguous()
    J_gn = J_b.permute(1, 2, 0).contiguous()
    del task, r_b, J_b
    P_, d_, N_ = J_gn.shape

    def cut(n):
        return r_gn[:, :n].contiguous(), J_gn[..., :n].contiguous()
    copies = [(r_gn.clone(), J_gn.clone()) for _ in range(cs.GN_COPIES)]
    small = [cut(cs.GN_RAGGED_N) for _ in range(cs.GN_COPIES)]
    for name, ins, cps, n in (
            ("gn_N%d_cold" % N_, (r_gn, J_gn), copies, N_),
            ("gn_N%d_l2" % N_, (r_gn, J_gn), [(r_gn, J_gn)], N_),
            ("gn_N%d_cold" % cs.GN_RAGGED_N, small[0], small,
             cs.GN_RAGGED_N),
            ("gn_N%d" % cs.GN_ODD_N, cut(cs.GN_ODD_N), [cut(cs.GN_ODD_N)],
             cs.GN_ODD_N)):
        turns(gn_swap, name, gk.gn_assembly, ins, cps,
              cs.gn_assembly_work(P_, d_, n), iters=10 * len(cps))


def launch_breakdown(fn, calls: int = 5):
    """Device time of each CUDA launch of one fn() call, in launch order:
    ``calls`` calls under torch.profiler, the raw (Kineto) kernel events
    sorted by start, split into the calls (each must show the same number
    of kernels) -> [(kernel name, mean us over the calls)], and the number
    of kernels a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted(((e.start_ns(), e.name(), e.duration_ns() / 1e3)
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA), key=lambda t: t[0])
    per = len(ev) // calls
    if per * calls != len(ev):
        cs.fail("launch_breakdown: %d kernel events over %d calls"
                % (len(ev), calls))
    return [(ev[i][1][:60], sum(ev[c * per + i][2] for c in range(calls))
             / calls) for i in range(per)], per


def _null():
    import contextlib
    return contextlib.nullcontext()


if __name__ == "__main__":
    sys.exit(main())
