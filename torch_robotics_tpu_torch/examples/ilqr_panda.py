"""Dynamically feasible Panda trajectories with batched iLQR (counterpart
of examples/ilqr_panda.py).

    python -m torch_robotics_tpu_torch.examples.ilqr_panda [--track]
    python torch_robotics_tpu_torch/examples/ilqr_panda.py \\
        [--device cpu] [--batch 64] [--track]

iLQR optimizes the controls of an exact double integrator, so its states
satisfy x_{t+1} = Phi x_t + B u_t to float precision.  With ``--track`` a
short-horizon iLQR controller (H = 16, 3 iterations a step) then tracks
receding windows of the converged plans.  Runs on the card unless
``--device cpu`` is given.
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from torch_robotics_tpu_torch.envs import EnvSpheres3D  # noqa: E402
from torch_robotics_tpu_torch.robots import RobotPanda  # noqa: E402
from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve  # noqa: E402
from torch_robotics_tpu_torch.tasks import PlanningTask  # noqa: E402


def main(device: str = "cuda", batch: int = 64, horizon: int = 32,
         opt_iters: int = 30, track: bool = False, n_exec: int = 40,
         max_samples: int = 4096, seed: int = 0) -> dict:
    robot = RobotPanda.create(device=device)
    # 0.06 cutoff: a wide repulsion buffer (at 0.03 fast transits graze
    # obstacles the hinge never saw)
    task = PlanningTask(env=EnvSpheres3D(device=device), robot=robot,
                        obstacle_cutoff_margin=0.06)
    d = robot.q_dim
    gen = torch.Generator().manual_seed(seed)
    qs, n1 = task.random_coll_free_q(gen, n_samples=batch,
                                     max_samples=max_samples)
    # goals: the first collision-free of 16 perturbations of each start,
    # inset 0.01 rad from the joint limits (a goal on a hard stop makes
    # the tracker graze out of limits), else the start itself
    noise = torch.randn((16, batch, d), generator=gen).to(qs.device)
    pert = torch.clamp(qs + 0.6 * noise, robot.q_min + 0.01,
                       robot.q_max - 0.01)
    free0 = ~task.compute_collision(pert.reshape(-1, d)).reshape(16, batch)
    idx = torch.argmax(free0.int(), dim=0)
    qg = torch.where(free0.any(0)[:, None],
                     pert[idx, torch.arange(batch, device=qs.device)], qs)
    start = torch.cat([qs, torch.zeros_like(qs)], -1)
    goal = torch.cat([qg, torch.zeros_like(qg)], -1)

    params = ILQRParams(n_support_points=horizon, dt=0.04,
                        opt_iters=opt_iters, sigma_coll=2e-3,
                        sigma_goal_prior=5e-3, sigma_limits=5e-3,
                        r_control=1e-6)
    limits = (robot.q_min, robot.q_max)
    res = ilqr_solve(task.collision_residuals, start, goal, params,
                     q_limits=limits)

    # feasibility: the states satisfy the double integrator
    q, qd = res.trajs[..., :d], res.trajs[..., d:]
    dt = params.dt
    q_pred = q[..., :-1, :] + dt * qd[..., :-1, :] \
        + 0.5 * dt * dt * res.controls
    feas = float((res.trajs[..., 1:, :d] - q_pred).abs().max())
    goal_dist = torch.linalg.vector_norm(res.trajs[:, -1, :d] - qg, dim=-1)
    frac_free = task.compute_fraction_free_trajs(res.trajs)
    peak = float(res.controls.abs().max())
    print(f"iLQR batch {batch}: dynamics feasibility max err {feas:.2e}")
    print(f"mean final goal distance {float(goal_dist.mean()):.3f} rad, "
          f"{int((goal_dist < 0.2).sum())}/{batch} within 0.2 rad")
    print(f"{frac_free * 100:.0f}% collision-free trajectories")
    print(f"peak |control| {peak:.1f} rad/s^2")
    out = dict(n_starts=n1, feasibility_err=feas,
               mean_final_goal_dist=float(goal_dist.mean()),
               fraction_free=frac_free, peak_control=peak)

    if track:
        # plan and track: a short-horizon controller follows receding
        # windows of the converged plan, so the executed paths keep the
        # plan's detours
        H_trk = 16
        p_trk = dataclasses.replace(
            params, n_support_points=H_trk, opt_iters=3,
            sigma_goal_running=0.05, r_control=1e-3)
        pad = goal[:, None].expand(batch, H_trk + n_exec, 2 * d)
        ref_full = torch.cat([res.trajs, pad], dim=1)
        x = start
        u_warm = torch.zeros((batch, H_trk - 1, d), device=qs.device)
        xs = [x]
        for t in range(n_exec):
            refs = ref_full[:, t + 1:t + 1 + H_trk]
            step = ilqr_solve(task.collision_residuals, x, goal, p_trk,
                              u_init=u_warm, x_ref=refs, q_limits=limits)
            x = step.trajs[:, 1, :]
            u_warm = torch.cat([step.controls[:, 1:], step.controls[:, -1:]],
                               dim=1)
            xs.append(x)
        exec_traj = torch.stack(xs, dim=1)
        dist = torch.linalg.vector_norm(exec_traj[:, -1, :d] - qg, dim=-1)
        frac = task.compute_fraction_free_trajs(exec_traj[..., :d])
        print(f"tracking MPC ({n_exec} steps): median final goal distance "
              f"{float(dist.median()):.4f} rad, "
              f"{frac * 100:.0f}% executed paths collision-free")
        out.update(track_median_goal_dist=float(dist.median()),
                   track_fraction_free=frac)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--track", action="store_true")
    args = ap.parse_args()
    main(args.device, args.batch, track=args.track)
