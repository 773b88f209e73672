"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line; any failure exits nonzero before the
final line):

1. build   - nvcc builds every CUDA kernel of the path from csrc/ (one
             process per source, all at once); prints build seconds and
             the card's name and power limit.
2. terms   - the fused GN-terms kernel vs its plain PyTorch version on the
             card: Panda in EnvSpheres3D at N = 64 * 1024 waypoints (the
             main path's first q, timed, and random q), plus a rounded-box
             scene and a rotated sharp-box scene with a tight workspace and
             wide self-collision margins at N = 4096.
3. solve   - the block-tridiagonal sweep vs its plain version: the first GN
             system of the main-path problem (H = 64, m = 14, B = 1024), a
             well-conditioned random system, and both at a ragged B = 100.
4. main    - the main path: receding-horizon MPC for the 7-DoF Panda in
             EnvSpheres3D, B = 1024, H = 64, 2 GN iterations per step, 8
             steps, start/goal drawn from a numpy seed as bench.py draws
             them; launch counts, finiteness, solves/s, a profile.
5. cpu     - one MPC step at B = 32, H = 64 on the card and on the CPU,
             each held to a float64 CPU step, GN iteration by GN iteration
             from the same input and over the chained step.
6. fk      - FK rollouts/s at B = 65536 through fk_positions_lanes.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
the final {"ok": true, "device": ...} line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B, H, N_STEPS, SEED = 1024, 64, 8, 0
ITERS_PER_STEP = 2
GP_PARAMS = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
                 sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
                 step_size=1.0)
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the terms test's tolerance (tests/test_pallas_terms.py): atol relative to
# the output's max, rtol elementwise; float32 sums in another order
TERMS_ATOL_REL, TERMS_RTOL = 3e-5, 2e-5
# solve tolerances relative to max|x|: a well-conditioned random system
# differs from the plain version only by float32 op order (1e-5).  The GN
# systems carry lam = 1e8 collision weights and are ill-conditioned, so two
# float32 solves differ by ~1e-3 from op order alone; there the kernel is
# held to a float64 solve of the same system and may be off by at most
# twice the plain float32 version's own error (+1e-5)
SOLVE_TOL_RANDOM, SOLVE_GN_FACTOR = 1e-5, 2.0
MPC_TOL = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def max_errs(got, ref):
    """(max |got - ref|, max |got - ref| / max |ref|) over paired outputs."""
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    rel = max(float((g - r).abs().max()) / (float(r.abs().max()) + 1e-30)
              for g, r in zip(got, ref))
    return abs_err, rel


# ----------------------------------------------------------------------
# work counts for the bounds (what these inputs need, from their shapes)
# ----------------------------------------------------------------------
def terms_work(lay, q, r):
    """(bytes, float ops) that the terms function needs on q (d, N), whose
    residual rows (the plain version's ``rows``) are r (R, N).

    Bytes: q (d, N) in, g (d, N), Hqq (d, d, N), cost (N) out.  Ops every
    lane needs: FK compose (~132 per revolute link, ~63 per fixed), world
    joint axes (18 per joint), the scene SDF of each object point (15 per
    point and object + ~10 / 25 / 12 per sphere / rounded box / sharp
    box), its workspace distance (12), each pair's distance (12) and each
    row's hinge (2).  Only an active row (r > 0 on this q) needs more, and
    only over its live Jacobian columns (the joint moves the row's point,
    or a pair's either point, and q is inside the joint's clamp): 18 per
    column of a point row (cross product + dot), 33 per column live at both
    points of a pair and 18 at one, then 2 + 2k + k(k+1) to add r^2, r Jr
    and Jr^T Jr over its k live columns."""
    import torch
    from torch_robotics_tpu_torch.geom.sdf import RoundedBoxes, Spheres
    model = lay.model
    d, N = q.shape
    n_rev = sum(1 for t in model.joint_types if t != 0)
    n_obj, n_pair = len(lay.obj_pos), len(lay.pair_a)
    per_lane = (132 * n_rev + 63 * (model.n_links - n_rev) + 18 * d
                + 12 * (n_obj + n_pair) + 2 * r.shape[0])
    for obj in lay.df_obj_list:
        per_lane += n_obj * 15
        for f in obj.fields:
            per = 10 if isinstance(f, Spheres) else (
                25 if isinstance(f, RoundedBoxes) else 12)
            per_lane += n_obj * per * f.centers.shape[0]

    ctrl = list(model.controlled_link_idxs())
    lo = torch.as_tensor(model.clamp_lower[ctrl], device=q.device)[:, None]
    hi = torch.as_tensor(model.clamp_upper[ctrl], device=q.device)[:, None]
    live_q = ((q >= lo) & (q <= hi))[None]                      # (1, d, N)
    act = (r > 0)[:, None]                                      # (R, 1, N)
    a, b = (torch.as_tensor(m, device=q.device)[:, :, None]
            for m in lay.row_joints())
    at_a, at_b = a & live_q & act, b & live_q & act             # (R, d, N)
    both = (at_a & at_b).sum(1)
    k = (at_a | at_b).sum(1)                                    # (R, N)
    row_ops = (33 * both + 18 * (k - both)
               + (2 + 2 * k + k * (k + 1)) * act[:, 0])
    return 4 * N * (2 * d + d * d + 1), per_lane * N + int(row_ops.sum())


def solve_work(H_: int, m: int, B_: int):
    """(bytes, float ops) of one sweep: D, U, b in, x out; ops counted from
    the kernel's loops (Cholesky, y, W, S, Wy per step; W x and the
    transposed triangular solve per backward step)."""
    chol = sum(2 * j + 1 for i in range(m) for j in range(i + 1))
    fwd = (m * (m + 1) // 2 + chol + sum(2 * i + 2 for i in range(m))
           + m * sum(2 * i + 1 for i in range(m))
           + m * (m + 1) // 2 * (2 * m - 1) + m * (2 * m - 1))
    bwd = sum(2 * (m - 1 - i) + 1 for i in range(m))
    ops = (H_ * (fwd + bwd) + (H_ - 1) * 2 * m * m) * B_
    nbytes = 4 * (H_ * m * m * B_ + H_ * m * m + 2 * H_ * m * B_)
    return nbytes, ops


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_build():
    from torch_robotics_tpu_torch.ops import btridiag_kernel, terms_kernel
    from torch_robotics_tpu_torch.ops.cuda_build import build_all
    t0 = time.perf_counter()
    logs = build_all([terms_kernel.KERNEL, btridiag_kernel.KERNEL])
    secs = time.perf_counter() - t0
    # resource report of the instantiations the main path launches
    report = {}
    for src, text in logs.items():
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if ("Compiling entry function '_ZN" in line
                    and ("terms_kernelILi7E" in line
                         or "btridiag_w_kernelILi14E" in line)):
                report[src] = " | ".join(s.strip().split("info    : ")[-1]
                                         for s in lines[i + 1:i + 4])
    terms_kernel.KERNEL.lib()
    btridiag_kernel.KERNEL.lib()
    smi = nvidia_smi_line()
    emit("build", seconds=round(secs, 3), ptxas=report, card=smi)
    return smi


def bench_problem(device, n_batch: int):
    """bench.py's start/goal draw (numpy seed) -> (task, start, goal)."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=EnvSpheres3D(device=device),
                        robot=RobotPanda.create(device=device),
                        obstacle_cutoff_margin=0.03)
    rng = np.random.default_rng(SEED)
    lo = task.robot.model.q_lower.astype(np.float64)
    hi = task.robot.model.q_upper.astype(np.float64)
    d = lo.shape[0]
    u1 = rng.uniform(size=(B, d))[:n_batch]
    u2 = rng.uniform(size=(B, d))[:n_batch]
    q_start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    z = np.zeros_like(q_start)
    start = torch.as_tensor(np.concatenate([q_start, z], -1),
                            dtype=torch.float32, device=device)
    goal = torch.as_tensor(np.concatenate([q_goal, z], -1),
                           dtype=torch.float32, device=device)
    return task, start, goal


def random_q(task, N: int, seed: int):
    """q (d, N) over 1.4x the joint range: some joints sit past their
    clamps (zeroed Jacobian columns)."""
    import torch
    rng = np.random.default_rng(seed)
    lo, hi = task.robot.model.q_lower, task.robot.model.q_upper
    u = rng.uniform(-0.2, 1.2, size=(lo.shape[0], N))
    q = lo[:, None] + u * (hi - lo)[:, None]
    return torch.as_tensor(q, dtype=torch.float32, device=task.device)


def phase_terms():
    import torch
    from torch_robotics_tpu_torch.envs import EnvBase, EnvMazeBoxes3D
    from torch_robotics_tpu_torch.geom import MultiSharpBoxField, ObjectField
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask

    from torch_robotics_tpu_torch.solve import straight_line_trajs
    task, start, goal = bench_problem("cuda", B)
    terms = task.collision_residuals.obstacle_terms_lanes
    N = H * B
    # the main path's first q: the straight-line plans, h-major lanes
    d = start.shape[1] // 2
    q_main = (straight_line_trajs(start, goal, H)[..., :d]
              .permute(2, 1, 0).reshape(d, N).contiguous())
    q = random_q(task, N, seed=1)
    results = {}

    def hold(name, got, ref):
        for g, r in zip(got, ref):
            tol = TERMS_ATOL_REL * float(r.abs().max()) + TERMS_RTOL * r.abs()
            check(bool(torch.isfinite(g).all()), name + ": non-finite terms")
            check(bool(((g - r).abs() <= tol).all()),
                  "%s: terms kernel disagrees with its plain version" % name)
        results[name] = max_errs(got, ref)

    main_key = "panda_spheres3d_main_q_N%d" % N
    hold(main_key, terms.unscaled(q_main), terms.plain.unscaled(q_main))
    hold("panda_spheres3d_random_q_N%d" % N, terms.unscaled(q),
         terms.plain.unscaled(q))

    box_robot = RobotPanda.create(self_collision_margin_robot=0.3,
                                  device="cuda")
    maze = PlanningTask(env=EnvMazeBoxes3D(device="cuda"), robot=box_robot,
                        obstacle_cutoff_margin=0.03)
    s2, c2 = np.sqrt(0.5), np.cos(0.3)
    sharp = ObjectField.create(
        [MultiSharpBoxField([[0.3, 0.1, 0.4], [-0.35, 0.2, 0.5]],
                            [[0.2, 0.3, 0.25], [0.15, 0.4, 0.2]],
                            device="cuda")],
        pos=[0.05, -0.1, 0.1], ori=[c2, s2 * np.sin(0.3), 0.0,
                                    s2 * np.sin(0.3)], device="cuda")
    sharp_task = PlanningTask(
        env=EnvBase(name="sharp", limits=[[-0.6, -0.6, -0.2],
                                          [0.6, 0.6, 0.9]],
                    obj_fixed_list=[sharp], device="cuda"),
        robot=box_robot, obstacle_cutoff_margin=0.03)
    for name, t in (("panda_maze_boxes3d_N4096", maze),
                    ("panda_sharp_boxes_tight_ws_N4096", sharp_task)):
        qb = random_q(t, 4096, seed=2)
        tt = t.collision_residuals.obstacle_terms_lanes
        hold(name, tt.unscaled(qb), tt.plain.unscaled(qb))

    # timed, and its work counted, on the main path's q
    k_ms = cuda_ms(lambda: terms.unscaled(q_main), iters=50)
    p_ms = cuda_ms(lambda: terms.plain.unscaled(q_main), iters=5, warmup=1)
    r_main = terms.plain.rows(q_main)[0]
    nbytes, ops = terms_work(TermsLayout(task), q_main, r_main)
    emit("terms", max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                            for k, v in results.items()},
         kernel_ms=k_ms, plain_ms=p_ms, bytes=nbytes, ops=ops,
         active_row_share=float((r_main > 0).float().mean()),
         kernel_ms_random_q=cuda_ms(lambda: terms.unscaled(q), iters=50))
    return dict(max_abs_err=results[main_key][0], ms=k_ms,
                plain_ms=p_ms, work=(nbytes, ops))


def dense_solve_fn(D, U, b):
    """One torch.linalg.solve on the dense (B, H m, H m) system: the library
    yardstick for the sweep (never used by the port)."""
    import torch
    H_, m, _, B_ = D.shape
    A = torch.zeros((B_, H_ * m, H_ * m), dtype=D.dtype, device=D.device)
    for k in range(H_):
        sl = slice(k * m, (k + 1) * m)
        A[:, sl, sl] = D[k].permute(2, 0, 1)
        if k + 1 < H_:
            nx = slice((k + 1) * m, (k + 2) * m)
            A[:, sl, nx] = U[k, :, :, 0]
            A[:, nx, sl] = U[k, :, :, 0].T
    rhs = b.permute(2, 0, 1).reshape(B_, H_ * m, 1)
    return lambda: torch.linalg.solve(A, rhs)


def phase_solve():
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system

    task, start, goal = bench_problem("cuda", B)
    theta0 = straight_line_trajs(start, goal, H)
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**GP_PARAMS))
    rng = np.random.default_rng(3)
    m = D_l.shape[1]
    A = rng.normal(size=(B, H, m, m)) * 0.3
    D_r = np.transpose(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m),
                       (1, 2, 3, 0))
    U_r = rng.normal(size=(H, m, m, 1)) * 0.2
    b_r = rng.normal(size=(H, m, B))
    rand = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (D_r, U_r, b_r)]
    results = {}
    for name, (D, U, b) in (("gn", (D_l, U_l, b_l)), ("random", rand)):
        for Bn in (B, 100):
            Dn = D[..., :Bn].contiguous()
            bn = b[..., :Bn].contiguous()
            x_k = solve_lanes_w(Dn, U, bn)
            x_p = solve_lanes_core(Dn, U, bn)
            x_64 = solve_lanes_core(Dn.double(), U.double(), bn.double())
            check(bool(torch.isfinite(x_k).all()), name + ": non-finite x")
            key = "%s_B%d" % (name, Bn)
            err, rel = max_errs([x_k], [x_p])
            rel_k64 = max_errs([x_k.double()], [x_64])[1]
            rel_p64 = max_errs([x_p.double()], [x_64])[1]
            if name == "random":
                ok = rel <= SOLVE_TOL_RANDOM
            else:
                ok = rel_k64 <= SOLVE_GN_FACTOR * rel_p64 + SOLVE_TOL_RANDOM
            check(ok, "%s: sweep disagrees (vs plain %.3g, vs float64 %.3g, "
                  "plain vs float64 %.3g of max|x|)"
                  % (key, rel, rel_k64, rel_p64))
            results[key] = dict(abs=err, rel_to_max=rel,
                                kernel_vs_f64=rel_k64, plain_vs_f64=rel_p64)
    try:
        solve_lanes_w(D_l, U_l.expand(H, m, m, 2).contiguous(),
                      b_l)
        fail("a per-batch U was accepted")
    except ValueError:
        pass
    k_ms = cuda_ms(lambda: solve_lanes_w(D_l, U_l, b_l), iters=20)
    p_ms = cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l), iters=2,
                   warmup=1)
    lib_ms = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=3, warmup=1)
    torch.cuda.empty_cache()
    emit("solve", max_errs=results,
         kernel_ms=k_ms, plain_ms=p_ms, dense_solve_ms=lib_ms)
    return dict(max_abs_err=results["gn_B%d" % B]["abs"], ms=k_ms,
                plain_ms=p_ms,
                library_ms=lib_ms, work=solve_work(H, m, B))


def run_mpc(task, start, goal, n_steps):
    import torch
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                                MPCState, mpc_step,
                                                straight_line_trajs)
    params = MPCParams(gpmp2=GPMP2Params(**GP_PARAMS),
                       iters_per_step=ITERS_PER_STEP)
    state = MPCState(theta=straight_line_trajs(start, goal, H), x=start)
    costs, thetas = [], []
    for _ in range(n_steps):
        state, info = mpc_step(task.collision_residuals, state, goal, params)
        costs.append(info["collision_cost"])
        thetas.append(state.theta)
    return state, torch.stack(costs), thetas


def phase_main():
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel, terms_kernel
    task, start, goal = bench_problem("cuda", B)
    run_mpc(task, start, goal, 1)                    # warm-up
    torch.cuda.synchronize()
    kernels = (terms_kernel.KERNEL, btridiag_kernel.KERNEL)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    state, costs, thetas = run_mpc(task, start, goal, N_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    expected = N_STEPS * ITERS_PER_STEP
    check(launches == [expected, expected],
          "main path launches %s, expected %d each" % (launches, expected))
    check(all(bool(torch.isfinite(t).all()) for t in thetas),
          "main path produced non-finite theta")
    check(bool(torch.isfinite(costs).all()), "non-finite collision costs")
    step_ms = ev0.elapsed_time(ev1) / N_STEPS

    # device busy share and kernel time by name over two more steps
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run_mpc(task, start, goal, 2)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + e.time_range.elapsed_us()
    dev_ms = sum(by_kernel.values()) / 1e3
    busy = dev_ms / prof_wall_ms if dev_ms > 0 else None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    emit("main", B=B, H=H, steps=N_STEPS, launches={
        "terms": launches[0], "btridiag_w": launches[1]},
        step_ms=step_ms, host_wall_step_ms=wall_s * 1e3 / N_STEPS,
        solves_per_s=B / (step_ms / 1e3),
        mean_collision_cost_last=float(costs[-1].mean()),
        profiled_device_busy_share=busy,
        profiled_device_ms_per_step=dev_ms / 2,
        top_device_ms_per_step={k: v / 2e3 for k, v in top})
    return launches


def theta_gaps(th_card, th_cpu, th_64):
    """Card and CPU float32 trajectories against a float64 one, relative to
    max|theta|: worst lane, median lane, lanes within MPC_TOL."""
    n = th_64.shape[0]
    scale = float(th_64.abs().max())

    def lanes(t):
        return ((t.cpu().double() - th_64).abs().reshape(n, -1).amax(1)
                / scale)

    out = {"card_vs_cpu": float((th_card.cpu() - th_cpu).abs().max())
           / scale}
    for who, t in (("card", th_card), ("cpu", th_cpu)):
        lane = lanes(t)
        out[who + "_vs_f64"] = float(lane.max())
        out[who + "_vs_f64_median_lane"] = float(lane.median())
        out[who + "_lanes_within_tol"] = int((lane <= MPC_TOL).sum())
    return out


def hold_to_f64(name: str, gaps) -> None:
    """The card may be off float64 by at most twice the CPU float32 run's
    own error (+1e-5 of max|theta|), in its worst and in its median lane."""
    for stat in ("_vs_f64", "_vs_f64_median_lane"):
        card, cpu = gaps["card" + stat], gaps["cpu" + stat]
        check(card <= 2.0 * cpu + 1e-5,
              "%s: card theta%s %.3g, CPU float32 %.3g" % (name, stat, card,
                                                            cpu))


def phase_cpu():
    """One MPC step (two GN iterations) at B = 32, H = 64 on the card and
    on the CPU, held to a float64 CPU step.

    At the main path's weights (lam = 1e8) the step is ill-conditioned in
    float32: a correct float32 step is off a float64 one by up to ~0.25 of
    max|theta| in a few lanes, in the JAX package as in the port, while in
    float64 the two agree to ~1e-10 (tests/test_torch_mpc_float64.py).  So
    card and CPU are not held to each other at MPC_TOL; each is held to the
    float64 step (hold_to_f64), both per GN iteration from the same input
    (where the costs are held card vs CPU at MPC_TOL) and over the chained
    step from the straight-line plan."""
    import torch
    from torch_robotics_tpu_torch.solve import (GPMP2Params, gpmp2_step,
                                                mpc_step, MPCParams,
                                                MPCState,
                                                straight_line_trajs)
    n = 32
    task_c, start_c, goal_c = bench_problem("cuda", n)
    task_h, start_h, goal_h = bench_problem("cpu", n)
    params = GPMP2Params(**GP_PARAMS)
    theta = straight_line_trajs(start_c, goal_c, H)
    iters = []
    for it in range(ITERS_PER_STEP):
        th_c, cost_c = gpmp2_step(task_c.collision_residuals, theta,
                                  start_c, goal_c, params)
        th_in = theta.cpu()
        th_h, cost_h = gpmp2_step(task_h.collision_residuals, th_in,
                                  start_h, goal_h, params)
        th_64, _ = gpmp2_step(task_h.collision_residuals, th_in.double(),
                              start_h.double(), goal_h.double(), params)
        rel_cost = float(((cost_c.cpu() - cost_h).abs()
                          / cost_h.abs().clamp(min=1e-30)).max())
        check(bool(torch.isfinite(th_c).all()), "card step non-finite")
        check(rel_cost <= MPC_TOL, "iteration %d: card vs CPU cost %.3g"
              % (it, rel_cost))
        gaps = theta_gaps(th_c, th_h, th_64)
        hold_to_f64("iteration %d" % it, gaps)
        iters.append(dict(gaps, cost_rel_err=rel_cost))
        theta = th_c

    mp = MPCParams(gpmp2=params, iters_per_step=ITERS_PER_STEP)
    th0 = straight_line_trajs(start_h, goal_h, H)
    s_c, _ = mpc_step(task_c.collision_residuals, MPCState(
        th0.cuda(), start_c), goal_c, mp)
    s_h, _ = mpc_step(task_h.collision_residuals, MPCState(th0, start_h),
                      goal_h, mp)
    s_64, _ = mpc_step(task_h.collision_residuals, MPCState(
        th0.double(), start_h.double()), goal_h.double(), mp)
    check(bool(torch.isfinite(s_c.theta).all()), "chained step non-finite")
    chained = theta_gaps(s_c.theta, s_h.theta, s_64.theta)
    hold_to_f64("chained step", chained)
    emit("cpu", B=n, H=H, iterations=iters, chained_step=chained)


def phase_fk():
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
    from torch_robotics_tpu_torch.robots import RobotPanda
    robot = RobotPanda.create(device="cuda")
    n = 65536
    rng = np.random.default_rng(4)
    lo, hi = robot.model.q_lower, robot.model.q_upper
    q = torch.as_tensor(lo + rng.uniform(size=(n, lo.shape[0])) * (hi - lo),
                        dtype=torch.float32, device="cuda")
    out = fk_positions_lanes(robot.model, q)
    check(tuple(out.shape) == (n, robot.model.n_links, 3)
          and bool(torch.isfinite(out).all()), "FK output")
    ms = cuda_ms(lambda: fk_positions_lanes(robot.model, q), iters=20)
    emit("fk", B=n, ms_per_call=ms, rollouts_per_s=n / (ms / 1e3))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "GPU port and needs a CUDA card")
    try:
        import torch_robotics_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("run from the root of a checkout: %s" % e)
    smi = phase_build()
    terms = phase_terms()
    solve = phase_solve()
    launches = phase_main()
    phase_cpu()
    phase_fk()

    entries = []
    for name, src, rep, res, n in (
            ("obstacle_terms", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", terms,
             launches[0]),
            ("btridiag_w", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", solve,
             launches[1])):
        b_ms, b_by = bound_ms(*res["work"])
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n,
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"], "bound_ms": b_ms,
                        "bound_by": b_by,
                        "library_ms": res.get("library_ms")})
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
