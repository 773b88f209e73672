"""Receding-horizon MPC: the Franka Panda in EnvSpheres3D, its rollouts
executed through the PD harness (counterpart of examples/mpc_panda.py).

    python -m torch_robotics_tpu_torch.examples.mpc_panda
    python torch_robotics_tpu_torch/examples/mpc_panda.py \\
        [--device cpu] [--batch 32] [--steps 60] [--record [PATH]]

Runs a batch of MPC problems between collision-free start and goal draws,
reports the distance to goal and the contact-free share of the executed
rollouts, then executes the rollouts through the PD harness
(``sim.MotionPlanningController``) and reports how many ran free.  Runs
on the card unless ``--device cpu`` is given.  ``--record`` (default path
``mpc_panda_execution.mp4``; a .gif where ffmpeg is missing) also
executes the first four rollouts under MuJoCo's contact dynamics
(``sim.MujocoExecutionEnv``, on the host) and draws the executed motion
with its collision spheres to video (``viz.PlanningVisualizer``); it
needs mujoco and matplotlib, and raises ImportError without them.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from torch_robotics_tpu_torch.envs import EnvSpheres3D  # noqa: E402
from torch_robotics_tpu_torch.robots import RobotPanda  # noqa: E402
from torch_robotics_tpu_torch.sim import (  # noqa: E402
    MotionPlanningController, PDControllerParams)
from torch_robotics_tpu_torch.solve import (GPMP2Params,  # noqa: E402
                                            MPCParams, mpc_rollout)
from torch_robotics_tpu_torch.tasks import PlanningTask  # noqa: E402


def main(device: str = "cuda", batch: int = 32, n_steps: int = 60,
         horizon: int = 32, max_samples: int = 2048, seed: int = 0,
         record=None) -> dict:
    env = EnvSpheres3D(device=device)
    robot = RobotPanda.create(device=device)
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.03)
    gen = torch.Generator().manual_seed(seed)
    starts, n1 = task.random_coll_free_q(gen, n_samples=batch,
                                         max_samples=max_samples)
    goals, n2 = task.random_coll_free_q(gen, n_samples=batch,
                                        max_samples=max_samples)
    print(f"sampled {n1}/{batch} starts, {n2}/{batch} goals collision-free")
    start = torch.cat([starts, torch.zeros_like(starts)], dim=-1)
    goal = torch.cat([goals, torch.zeros_like(goals)], dim=-1)

    gp = GPMP2Params(n_support_points=horizon, dt=0.04, sigma_start=1e-3,
                     sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=2e-3,
                     step_size=0.8)
    xs, info = mpc_rollout(task.collision_residuals, start, goal,
                           MPCParams(gpmp2=gp, iters_per_step=2),
                           n_steps=n_steps)
    dist = info["dist_to_goal"][-1]
    n_near = int((dist < 0.2).sum())
    print(f"MPC: mean final distance to goal {float(dist.mean()):.3f} rad, "
          f"{n_near}/{batch} within 0.2 rad")
    # contact check at margin 0 (penetration, not the safety margins)
    coll = task.compute_collision(xs, margin=0.0)
    frac_free = float((~coll.any(dim=-1)).float().mean())
    print(f"{frac_free * 100:.0f}% of executed rollouts contact-free")

    result, n_free = MotionPlanningController(
        task, PDControllerParams(dt=gp.dt)).run_trajectories(xs)
    track = float(result.tracking_error.mean())
    print(f"PD execution: {n_free}/{batch} rollouts ran without contact, "
          f"mean tracking error {track:.4f} rad")
    out = dict(n_starts=n1, n_goals=n2,
               mean_final_dist=float(dist.mean()), n_within_0_2=n_near,
               fraction_contact_free=frac_free, executed_free=n_free,
               tracking_error=track)
    if record:
        out.update(record_execution(task, xs, gp.dt, record))
    return out


def record_execution(task, xs, dt: float, path, n_rec: int = 4) -> dict:
    """The first ``n_rec`` rollouts of xs (B, T, 2 d) executed under
    MuJoCo's contact dynamics and drawn to the video ``path`` -> the
    contacts reported and the path written."""
    import matplotlib
    matplotlib.use("Agg")
    from torch_robotics_tpu_torch.sim import MujocoExecutionEnv
    from torch_robotics_tpu_torch.viz import PlanningVisualizer
    robot = task.robot
    sim = MujocoExecutionEnv(robot, env=task.env)
    result = sim.run_trajectories(xs[:n_rec, :, :robot.q_dim], dt_plan=dt)
    n = result.contact.shape[0]
    print(f"MuJoCo execution: {int(result.contact.sum())}/{n} rollouts "
          f"reported contact")
    written = PlanningVisualizer(task=task).animate_execution(
        result.qpos_executed, contact=result.contact,
        contact_step=result.contact_step, video_filepath=str(path),
        anim_time=6.0)
    print(f"wrote execution video to {written}")
    return dict(mujoco_contacts=int(result.contact.sum()),
                record_path=written)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--record", nargs="?", const="mpc_panda_execution.mp4",
                    default=None, metavar="PATH",
                    help="record MuJoCo-executed rollouts to mp4 / gif")
    args = ap.parse_args()
    main(args.device, args.batch, args.steps, record=args.record)
