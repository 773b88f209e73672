"""Time the sweep kernels of this checkout against those of another checkout
of the repository (e.g. the parent commit), in turns, in one process on one
NVIDIA GPU.

    git archive <commit> | tar -x -C chip_checkout/other   # a git-ignored dir
    python3 chip_sweep_ab.py --other chip_checkout/other [--out FILE] \
        [--kernels all|sweep|riccati|cols|cost|net]

The other checkout's ``csrc/btridiag.cu``, ``csrc/btridiag_sweep.cu``,
``csrc/riccati.cu`` and ``csrc/btridiag_cols.cu`` are built beside this
tree's (``ops.cuda_build``) and stand in for this tree's libraries while
its turn runs: the wrappers, problems and timing are this tree's, so only
the kernels differ (a launch function with another argument list is
called with the arguments its own tree's wrapper gave it: the sweeps'
lanes per block dropped, the Riccati sweep's device scratch allocated).
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
holds them, and the kernels the sweep change left alone are compared bit
for bit on the same inputs: K9's substitution (fed the same factors) and
K3 (both tails).

``--kernels riccati`` (the iLQR path):

- K6 on the inputs of the iLQR path's first iteration (T = 31, P = 27, B =
  512) and of the tracking loop's first step (T = 15, P = 34), each
  side's output held to a float64 plain version as ``chip_smoke.py``
  holds it;
- K7 on the path's inputs, bit for bit the same on both sides;
- phase ``ilqr``'s solve (30 iterations, B = 512): ms per iteration by
  CUDA events, and once per side a profile (device ms per iteration, busy
  share);
- phase ``ilqr_mpc``'s tracking loop (30 steps): ms per step.

``--kernels cols`` (the column sweep, config 4's path):

- K4 at (32, 40, 40, 256) on phase ``mr_solve``'s GN system and on a
  random system: each side's x ``torch.equal`` to the other's, and held to
  float64 as ``chip_smoke.py`` holds it; this tree's kernel also timed at
  one and at two lanes a block, and at B = 8, 132 and 256;
- the multi-robot MPC (phase ``mr_mpc``, 30 steps): ms per step by CUDA
  events, and once per side a profile (device ms per step, busy share).

``--kernels cost`` (the value-only collision cost, K8, both branches): the
other tree's cost kernels (an older tree's ``trt_cost_launch`` in
``terms.cu`` and ``trt_mr_cost_launch`` in ``mr_terms.cu``, each given
the parameters its own tree packs for the same task) stand in for
``cost.cu`` under this tree's wrappers:

- ptxas's report (stack frame, spills, registers) of both sides' cost
  kernels;
- K8 on the iLQR path's line-search q (N = 79,360), on the sGPMP Panda
  path's first candidates (N = 2,097,152) and proposal (N = 131,072); K8's
  MultiRobot branch on config 4's sGPMP candidates (N = 131,072) and
  proposal (N = 8,192) and on random q at the tight poses (N = 8,192):
  each side held to the plain version, the max |difference| between the
  sides, whether they agree bit for bit, the kernel's device time (by the
  profiler) and the time a call takes (by CUDA events, host included) in
  turns, and the bound;
- the sGPMP Panda and config-4 iterations in turns (ms per iteration by
  CUDA events) and once per side a profile (device ms per iteration, busy
  share);
- K1 and K5, which the change leaves alone, bit for bit between the two
  trees on the same q.

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

``--kernels all`` (the default) runs the sweeps and the Riccati sweep;
``cols``, ``cost`` and ``net`` run alone.  Prints one JSON line per
measurement, then the card's name and power limit; ``--out`` writes all of
it as one JSON object.
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
    """The other checkout's btridiag.cu and btridiag_sweep.cu kernels, with
    the argtypes its launch functions take (an older sweep takes no
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
        "trt_btridiag_subst_launch": [P] * 5 + [I] * 3 + [P]})
    k3 = OtherKernel(str(csrc / "btridiag_sweep.cu"),
                    dict(bk.SWEEP_KERNEL.functions))
    return main, k3, takes_lanes


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


def other_riccati_kernel(csrc: Path):
    """The other checkout's riccati.cu, with the argtypes of its Riccati
    launch function (an older sweep takes a device scratch Fw (M, P, B) and
    no launch shape)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import riccati_kernel as rk
    OtherKernel = other_kernel_class()
    takes_fw = "float* Fw" in (csrc / "riccati.cu").read_text()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sweep = ([P] * 7 + [I] * 4 + [F] * 6 + [P] if takes_fw
             else rk.RICCATI_KERNEL.functions["trt_riccati_launch"])
    return OtherKernel(str(csrc / "riccati.cu"), {
        "trt_riccati_launch": sweep,
        "trt_rollout_launch": rk.ROLLOUT_KERNEL.functions[
            "trt_rollout_launch"]}), takes_fw


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


def other_cost_kernels(csrc: Path):
    """The other checkout's terms.cu (K1 and, in an older tree, K8) and
    mr_terms.cu (K5 and, in an older tree, K8's MultiRobot branch)."""
    import ctypes

    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    OtherKernel = other_kernel_class()
    P, I = ctypes.c_void_p, ctypes.c_int
    terms = OtherKernel(str(csrc / "terms.cu"), {
        **tk.KERNEL.functions,
        "trt_cost_launch": [P, P, I, I, P, P, P]})
    mr = OtherKernel(str(csrc / "mr_terms.cu"), {
        **tk.MR_KERNEL.functions,
        "trt_mr_cost_launch": [P, P, I, I, I, P, P, P]})
    return terms, mr


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

    def route(name, args):
        if name == "trt_btridiag_sweep_launch":
            return k3, args
        if (name in ("trt_btridiag_w_launch", "trt_btridiag_factor_launch")
                and not takes_lanes):
            args = args[:10] + args[11:]          # drop lanes_per_block
        return main, args
    return Swap(bk, ("KERNEL", "FACTOR_KERNEL", "SUBST_KERNEL",
                     "SWEEP_KERNEL"), route)


def cols_swap(other, takes_lanes):
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk

    def route(name, args):
        # (D, U, b, x, Lg, H, m, B, lanes, stream): drop lanes for an older
        # kernel (its scratch, (B, H, m, m), fits in the one given)
        return other, (args if takes_lanes else args[:8] + args[9:])
    return Swap(bk, ("COLS_KERNEL",), route)


def riccati_swap(other, takes_fw):
    import torch
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk

    def route(name, args):
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


def cost_swap(terms, mr, tasks):
    """The other tree's K8 kernels under this tree's cost wrappers: a
    launch on the cost parameters of one of ``tasks`` goes to the other
    tree's kernel with that tree's own packing of the task (the parent's
    terms.cu and mr_terms.cu packings)."""
    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    table = {}
    for task in tasks:
        ints = task.collision_residuals.collision_cost_lanes.params[1]
        if hasattr(task.robot, "robots"):
            d, i_o, f_o, n_bp, _ = tk._mr_kernel_params(task)
            table[ints.data_ptr()] = ("trt_mr_cost_launch", mr, (
                n_bp, tk.mr_shared_bytes(i_o.cpu().numpy(), cost_only=True),
                i_o.data_ptr(), f_o.data_ptr()), (i_o, f_o))
        else:
            d, i_o, f_o, _ = tk._kernel_params(task)
            table[ints.data_ptr()] = ("trt_cost_launch", terms, (
                d, i_o.data_ptr(), f_o.data_ptr()), (i_o, f_o))

    def route(name, args):
        # (q, cost, N, D, lanes, T, smem, ip, n_ints, fp, n_floats, stream)
        fn, kernel, extra, _ = table[args[7]]
        return kernel, args[:3] + extra + args[11:], fn
    return Swap(tk, ("COST_KERNEL", "MR_COST_KERNEL"), route)


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


def terms_swap(terms, mr):
    """The other tree's K1 and K5 under this tree's terms wrappers."""
    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    return Swap(tk, ("KERNEL", "MR_KERNEL"),
                lambda name, args: (terms if name == "trt_terms_launch"
                                    else mr, args))


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
                    choices=("all", "sweep", "riccati", "cols", "cost",
                             "net"),
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
    do_cost = args.kernels == "cost"
    do_net = args.kernels == "net"
    sweep_k = other_sweep_kernels(csrc) if do_sweep else None
    net_k = other_net_kernel(csrc) if do_net else None
    ric_k = other_riccati_kernel(csrc) if do_riccati else None
    cols_k = other_cols_kernel(csrc) if do_cols else None
    cost_k = other_cost_kernels(csrc) if do_cost else ()
    build_all([*(sweep_k[:2] if do_sweep else ()),
               *(ric_k[:1] if do_riccati else ()),
               *(cols_k[:1] if do_cols else ()), *cost_k,
               *(net_k[:1] if do_net else ()),
               *cs.all_kernels().values()])
    report = {}

    def emit(name, **fields):
        report[name] = fields
        print(json.dumps({"ab": name, **fields}), flush=True)

    if do_riccati:
        ab_riccati(riccati_swap(*ric_k), emit)
        torch.cuda.empty_cache()
    if do_sweep:
        ab_sweeps(sweep_swap(*sweep_k), emit)
    if do_cols:
        ab_cols(cols_swap(*cols_k), emit)
    if do_cost:
        ab_cost(cost_k, emit)
    if do_net:
        ab_net(*net_k, emit)

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, **report}, indent=1))


def ab_riccati(swap, emit):
    """K6 at T = 31 and T = 15, K7 bit for bit, phase ilqr's ms per
    iteration (and a profile per side), ilqr_mpc's ms per step."""
    import torch
    from torch_robotics_tpu_torch.ops.riccati_kernel import (
        linesearch_rollout_kernel_factory, riccati_backward_kernel_factory,
        riccati_launch_config)
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve

    task, start, goal = cs.ilqr_problem("cuda")
    seen = cs.capture_first_iteration(task, start, goal)
    mpc_args, mpc_ins = cs.capture_mpc_sweep(task, start, goal)
    for name, (s_args, ins) in (("k6_T%d" % seen["sweep"][0][3],
                                 seen["sweep"]),
                                ("k6_T%d" % mpc_args[3], (mpc_args, mpc_ins))):
        fn = riccati_backward_kernel_factory(*s_args)
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
        errs["other_vs_this"] = cs.max_errs(outs["other"], outs["this"])[0]
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(lambda: fn(*ins), iters=20))
        d, m, P, T = s_args[:4]
        B = ins[0].shape[-1]
        emit(name, shape=dict(T=T, d=d, P=P, B=B), other_ms=other_ms,
             this_ms=this_ms, speedup=other_ms / this_ms, turns_ms=turns,
             bound_ms=cs.bound_ms(*cs.riccati_work(d, m, P, T, B))[0],
             launch=riccati_launch_config(d, P, B), vs_float64=errs)

    # K7, which this change leaves alone, bit for bit on the same inputs
    r_args, r_ins = seen["roll"]
    roll = linesearch_rollout_kernel_factory(*r_args)
    with swap:
        other = roll(*r_ins)
    same = all(torch.equal(a, b) for a, b in zip(other, roll(*r_ins)))
    emit("k7_bit_for_bit", same=same)
    if not same:
        cs.fail("K7 differs from the other tree's")

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

    plan = solve().trajs
    with swap:
        solve()
    other_ms, this_ms, turns = in_turns(
        swap, lambda: events_ms(solve)[0] / cs.IL_ITERS)
    prof = {}
    for side in ("other", "this"):
        with (swap if side == "other" else _null()):
            busy, dev_ms, top = cs.profile_device(solve, cs.IL_ITERS)
        prof[side] = dict(profiled_device_busy_share=busy,
                          profiled_device_ms_per_iteration=dev_ms,
                          top_device_ms_per_iteration=top)
    emit("ilqr_iteration", B=cs.IL_B, H=cs.IL_H, iterations=cs.IL_ITERS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns, profile=prof)

    def mpc():
        return cs.ilqr_mpc_loop(task, start, goal, plan, cs.MPC_STEPS)
    cs.ilqr_mpc_loop(task, start, goal, plan, 1)
    with swap:
        cs.ilqr_mpc_loop(task, start, goal, plan, 1)
    other_ms, this_ms, turns = in_turns(
        swap, lambda: events_ms(mpc)[0] / cs.MPC_STEPS)
    emit("ilqr_mpc_step", B=cs.IL_B, H=cs.MPC_H, steps=cs.MPC_STEPS,
         other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
         turns_ms=turns)


def ab_sweeps(swap, emit):
    """K2 at m = 14 and 4, K9's factor, K3 and K9's substitution bit for
    bit, the main path's step, reuse k = 1, 2, 4."""
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_solve
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core, solve_lanes_factor_core)
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

    # the kernels this change leaves alone, bit for bit on the same inputs
    x, L, W = bk.solve_lanes_factor(Df, Uf, bf)
    same = {}
    with swap:
        xs_other = bk.solve_lanes_subst(L, W, bf)
        k3_other = [bk.solve_lanes_sweep(D14, U14, b14, bwd_trsv=t)
                    for t in (False, True)]
    same["k9_subst"] = bool(torch.equal(xs_other,
                                        bk.solve_lanes_subst(L, W, bf)))
    for t, xo in zip((False, True), k3_other):
        same["k3_%s" % ("trsv" if t else "trsm")] = bool(torch.equal(
            xo, bk.solve_lanes_sweep(D14, U14, b14, bwd_trsv=t)))
    emit("unchanged_kernels_bit_for_bit", **same)
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
        emit("reuse_k%d" % k, ms_per_iteration={"other": other_ms,
                                                 "this": this_ms},
             speedup=other_ms / this_ms, turns_ms=turns)



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


def ab_cost(other, emit):
    """K8 and K8-MultiRobot at the path shapes (each side held to plain,
    the sides' difference, turns, bound), the sGPMP iterations in turns
    with a profile per side, K1 and K5 bit for bit."""
    import dataclasses

    import numpy as np
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.solve import SGPMPParams, sgpmp_solve

    from torch_robotics_tpu_torch.ops.terms_kernel import COST_KERNEL

    # ptxas's report of each side's cost kernels, from the build logs
    def ptxas(kernel, fragment):
        lines = kernel.library_path.with_suffix(".log").read_text() \
            .splitlines()
        return [" | ".join(x.strip().split("info    : ")[-1]
                           for x in lines[i + 1:i + 4])
                for i, line in enumerate(lines)
                if "Compiling entry function" in line and fragment in line]
    emit("ptxas", other={"cost_kernel<7>": ptxas(other[0], "cost_kernelILi7E"),
                         "mr_terms_kernel<cost only>": ptxas(
                             other[1], "mr_terms_kernelILb1E")},
         this={"cost_kernel": ptxas(COST_KERNEL, "11cost_kernelE")})

    il_task, il_start, il_goal = cs.ilqr_problem("cuda")
    mr, mr_start, mr_goal, _ = cs.mr_problem("cuda")
    tight = cs.mr_task("cuda", cs.MR_TIGHT_POSES)
    swap = cost_swap(*other, (il_task, mr, tight))
    q_ls = cs.capture_first_iteration(il_task, il_start, il_goal)[
        "cost_%d" % (len(cs.IL_ALPHAS) * cs.IL_B * (cs.IL_H - 1))]
    sg = cs.sg_problem(il_start, il_goal, cs.SG_PART, cs.IL_H,
                       cs.SG_PARAMS["dt"], cs.SEED + 2)
    mr_sg = cs.sg_problem(mr_start, mr_goal, 1, cs.MR_H, cs.MR_GP["dt"],
                          cs.SEED + 3)
    q_sg = cs.capture_cost_inputs(il_task, *sg, cs.SG_PARAMS)
    q_mr = cs.capture_cost_inputs(mr, *mr_sg, cs.MR_SG_PARAMS)
    rng = np.random.default_rng(13)
    lo = tight.robot.q_min.cpu().numpy()
    hi = tight.robot.q_max.cpu().numpy()
    q_tight = torch.as_tensor(
        lo[:, None] + rng.uniform(size=(lo.shape[0], 8192))
        * (hi - lo)[:, None], dtype=torch.float32, device="cuda")
    lay = TermsLayout(il_task)
    mlay = mr.collision_residuals.obstacle_terms_lanes.plain.layout
    n_rows = len(lay.obj_pos) * 2 + len(lay.pair_a)
    m_rows = len(mlay.obj_pos) * 2 + len(mlay.pair_a)
    cases = [("k8_line_search", il_task, q_ls), *(
        ("k8_sgpmp_N%d" % n, il_task, q) for n, q in sorted(q_sg.items())),
        *(("k8_mr_sgpmp_N%d" % n, mr, q) for n, q in sorted(q_mr.items())),
        ("k8_mr_tight_random", tight, q_tight)]
    for name, task, q in cases:
        cost = task.collision_residuals.collision_cost_lanes
        ref = cost.plain(q)
        outs, errs = {}, {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                outs[side] = cost(q).clone()
            errs[side] = cs.hold_cost("%s_%s" % (name, side), outs[side],
                                      ref)
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.device_ms(lambda: cost(q), iters=20))
        other_call, this_call, _ = in_turns(
            swap, lambda: cs.cuda_ms(lambda: cost(q), iters=20))
        N = q.shape[1]
        work = (cs.cost_work(lay, N, n_rows) if task is il_task
                else cs.mr_cost_work(mlay, N, m_rows))
        emit(name, N=N, bit_for_bit=bool(torch.equal(outs["other"],
                                                      outs["this"])),
             max_abs_diff=float((outs["other"] - outs["this"]).abs().max()),
             vs_plain={k: {"abs": v[0], "rel_to_max": v[1]}
                       for k, v in errs.items()},
             other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
             turns_ms=turns, call_ms={"other": other_call, "this": this_call},
             bound_ms=cs.bound_ms(*work)[0], launch=cost.params[3])
        torch.cuda.empty_cache()

    # K1 and K5, which this change leaves alone, bit for bit on the same q
    tswap = terms_swap(*other)
    same = {}
    for name, task, q in (("k1", il_task, q_ls),
                          ("k5", mr, q_mr[cs.MR_B * cs.MR_H])):
        unscaled = task.collision_residuals.obstacle_terms_lanes.unscaled
        with tswap:
            o = [t.clone() for t in unscaled(q)]
        same[name] = all(torch.equal(a, b) for a, b in zip(o, unscaled(q)))
    emit("unchanged_kernels_bit_for_bit", **same)
    if not all(same.values()):
        cs.fail("a kernel this change leaves alone differs: %s" % same)

    # the sGPMP iterations, in turns, and a profile per side
    for name, task, (theta0, s, g), params in (
            ("sgpmp_panda", il_task, sg, cs.SG_PARAMS),
            ("sgpmp_config4", mr, mr_sg, cs.MR_SG_PARAMS)):
        p = SGPMPParams(**dict(params, opt_iters=10))

        def solve(n_iter=p.opt_iters):
            return sgpmp_solve(
                task.collision_residuals, theta0, s, g,
                dataclasses.replace(p, opt_iters=n_iter),
                generator=torch.Generator(device="cuda").manual_seed(7))
        solve(2)
        with swap:
            solve(2)
        other_ms, this_ms, turns = in_turns(
            swap, lambda: cs.cuda_ms(solve, iters=1, warmup=0)
            / p.opt_iters)
        prof = {}
        for side in ("other", "this"):
            with (swap if side == "other" else _null()):
                busy, dev_ms, top = cs.profile_device(lambda: solve(5), 5)
            prof[side] = dict(profiled_device_busy_share=busy,
                              profiled_device_ms_per_iteration=dev_ms,
                              top_device_ms_per_iteration=top)
        emit(name + "_iteration", B=theta0.shape[0], iterations=p.opt_iters,
             other_ms=other_ms, this_ms=this_ms, speedup=other_ms / this_ms,
             turns_ms=turns, profile=prof)
        torch.cuda.empty_cache()


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


def _null():
    import contextlib
    return contextlib.nullcontext()


if __name__ == "__main__":
    sys.exit(main())
