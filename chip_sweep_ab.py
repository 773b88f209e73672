"""Time the block-tridiagonal sweep kernels of this checkout against those of
another checkout of the repository (e.g. the parent commit), in turns, in
one process on one NVIDIA GPU.

    git archive <commit> | tar -x -C chip_checkout/other   # a git-ignored dir
    python3 chip_sweep_ab.py --other chip_checkout/other [--out FILE]

The other checkout's ``csrc/btridiag.cu`` and ``csrc/btridiag_sweep.cu``
are built beside this tree's (``ops.cuda_build``) and stand in for this
tree's libraries while its turn runs: the wrappers, problems and timing are
this tree's, so only the kernels differ.  Each measurement runs in the
order other, this, this, other (each side's time the mean of its two), on
the problems of ``chip_smoke.py``:

- K2 at (64, 14, 1024) on the main path's first GN system, and at config
  2's (64, 4, 1024);
- K9's factor sweep at the reuse workload's (32, 14, 256), beside one
  ``torch.linalg.cholesky`` of the dense system;
- the main path (8 MPC steps of ``chip_smoke.run_mpc``): ms per step by
  CUDA events, and once per side a profile (device ms per step, busy
  share);
- the reuse workload's solve at refactor_every 1, 2, 4 (ms per iteration).

Each side's K2 and K9 outputs are held to float64 as ``chip_smoke.py``
holds them, and the kernels this change leaves alone are compared bit for
bit on the same inputs: K9's substitution (fed the same factors) and K3
(both tails).  Prints one JSON line per measurement, then the card's name
and power limit; ``--out`` writes all of it as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as cs


def other_kernels(other: Path):
    """CudaKernels on the other checkout's sources, with the argtypes its
    launch functions take (the sweeps gained a lanes-per-block argument),
    each library named by the other checkout's own source and headers."""
    import ctypes
    import hashlib

    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.ops.cuda_build import BUILD_DIR, CudaKernel

    class OtherKernel(CudaKernel):
        @property
        def library_path(self):
            h = hashlib.sha256(self.source.read_bytes())
            for header in sorted(self.source.parent.glob("*.cuh")):
                h.update(header.read_bytes())
            return BUILD_DIR / ("other-%s-%s.so" % (self.source.stem,
                                                    h.hexdigest()[:16]))

    csrc = (other / "torch_robotics_tpu_torch" / "csrc").resolve()
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


class Swap:
    """Stands in for this tree's btridiag.cu and btridiag_sweep.cu kernels
    (the wrappers' module globals) while the other side's turn runs."""

    NAMES = ("KERNEL", "FACTOR_KERNEL", "SUBST_KERNEL", "SWEEP_KERNEL")

    def __init__(self, main, k3, takes_lanes):
        self.main, self.k3, self.takes_lanes = main, k3, takes_lanes
        self.launches = 0

    def launch(self, name, *args):
        if name == "trt_btridiag_sweep_launch":
            self.k3.launch(name, *args)
        else:
            if (name in ("trt_btridiag_w_launch",
                         "trt_btridiag_factor_launch")
                    and not self.takes_lanes):
                args = args[:10] + args[11:]      # drop lanes_per_block
            self.main.launch(name, *args)
        self.launches += 1

    def __enter__(self):
        from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
        self.saved = {n: getattr(bk, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(bk, n, self)
        return self

    def __exit__(self, *exc):
        from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
        for n, k in self.saved.items():
            setattr(bk, n, k)


def in_turns(swap, fn):
    """fn() in the order other, this, this, other -> (other's mean, this
    tree's mean, the four results in that order)."""
    import contextlib
    out = []
    for side in ("other", "this", "this", "other"):
        with (swap if side == "other" else contextlib.nullcontext()):
            out.append(fn())
    return (out[0] + out[3]) / 2, (out[1] + out[2]) / 2, out


def main() -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script times "
                "CUDA kernels")
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.ops.cuda_build import build_all
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_solve
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core, solve_lanes_factor_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system

    main_k, k3_k, takes_lanes = other_kernels(args.other)
    build_all([main_k, k3_k, *cs.all_kernels().values()])
    swap = Swap(main_k, k3_k, takes_lanes)
    report = {}

    def emit(name, **fields):
        report[name] = fields
        print(json.dumps({"ab": name, **fields}), flush=True)

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

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, **report}, indent=1))


def _null():
    import contextlib
    return contextlib.nullcontext()


if __name__ == "__main__":
    sys.exit(main())
