"""How far five Pandas' first GN iteration lands from float64 on the card
and on the CPU, by lane count: the accuracy behind phase ``mr_five``'s
float64 hold (``chip_smoke.MR_FIVE_F64_B``) and K4's shared-memory route
(``csrc/btridiag_cols_wide.cu``) against the plain solve.

    python3 chip_cols_wide_f64.py [--out chiprun_out/cols_wide_f64.json]

For the first n = 16, 64 and 256 problems of ``chip_smoke.mr_problem``'s
five-Panda draw, one GN iteration from the straight-line plans, each held
to a float64 CPU iteration, relative to max|theta| (worst and median
lane): the CPU float32 iteration (what ``step_vs_f64`` holds the card
to), the card's (K5 and the shared-memory route), the card's GN system
through the plain solve, and the card's float32 GN system solved in
float64 (the system's own float32 error).  Also the route's and the
plain solve's x off float64 on random SPD systems at m = 70 and 128.
Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import json
import sys
from pathlib import Path

import chip_smoke as c


def gaps(n, task, task_h, start, goal, params):
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import \
        solve_lanes_cols_wide
    from torch_robotics_tpu_torch.solve import gpmp2_step, straight_line_trajs
    from torch_robotics_tpu_torch.solve.btridiag_lanes import solve_lanes_core
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    s, g = start[:n].contiguous(), goal[:n].contiguous()
    th = straight_line_trajs(s, g, c.MR_H)
    th64, _ = gpmp2_step(task_h.collision_residuals, th.cpu().double(),
                         s.cpu().double(), g.cpu().double(), params)
    scale = float(th64.abs().max())

    def gap(t):
        lane = ((t.cpu().double() - th64).abs().reshape(n, -1).amax(1)
                / scale)
        return dict(worst=float(lane.max()), median=float(lane.median()))
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, th, s, g, params)

    def step(x):
        return th.double() + params.step_size * x.permute(2, 0, 1).double()
    return dict(
        cpu_float32=gap(gpmp2_step(task_h.collision_residuals, th.cpu(),
                                   s.cpu(), g.cpu(), params)[0]),
        card=gap(gpmp2_step(task.collision_residuals, th, s, g, params)[0]),
        card_system_plain_solve=gap(step(solve_lanes_core(D_l, U_l, b_l))),
        card_system_route=gap(step(solve_lanes_cols_wide(D_l, U_l, b_l))),
        card_system_float64_solve=gap(step(solve_lanes_core(
            D_l.double(), U_l.double(), b_l.double()))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        c.fail("this script needs a CUDA card")
    from torch_robotics_tpu_torch.ops.btridiag_kernel import \
        solve_lanes_cols_wide
    from torch_robotics_tpu_torch.solve import GPMP2Params
    from torch_robotics_tpu_torch.solve.btridiag_lanes import solve_lanes_core
    out = {"card": c.nvidia_smi_line(), "random": {}, "mr_five": {}}
    for H_, m, B_ in ((32, 70, 256), (32, 128, 64)):
        D, U, b = c.random_wide_system(H_, m, B_, seed=m)
        x64 = solve_lanes_core(D.double(), U.double(), b.double())
        out["random"]["m%d" % m] = {
            name: c.max_errs([x.double()], [x64])[1] for name, x in (
                ("route", solve_lanes_cols_wide(D, U, b)),
                ("plain", solve_lanes_core(D, U, b)))}
    task, start, goal, _ = c.mr_problem(
        "cuda", task=c.mr_task("cuda", *c.MR_CELLS["mr_five"]))
    task_h = c.mr_task("cpu", *c.MR_CELLS["mr_five"])
    for n in (16, 64, 256):
        out["mr_five"]["n%d" % n] = gaps(n, task, task_h, start, goal,
                                         GPMP2Params(**c.MR_GP))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
