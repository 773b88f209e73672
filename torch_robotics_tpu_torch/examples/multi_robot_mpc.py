"""Multi-robot MPC: two Pandas and a UR10 in one workspace (counterpart of
examples/multi_robot_mpc.py).

    python -m torch_robotics_tpu_torch.examples.multi_robot_mpc
    python torch_robotics_tpu_torch/examples/multi_robot_mpc.py \\
        [--device cpu] [--batch 16] [--steps 150]

``MultiRobot`` composes the arms at their base poses and adds
mutual-collision pairs between every two members, so the coupled q_dim =
20 system is planned jointly: each arm avoids the scene and the other
arms.  Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from torch_robotics_tpu_torch.core import z_rot  # noqa: E402
from torch_robotics_tpu_torch.envs import EnvSpheres3D  # noqa: E402
from torch_robotics_tpu_torch.robots import (MultiRobot,  # noqa: E402
                                             RobotPanda, RobotUR10)
from torch_robotics_tpu_torch.solve import (GPMP2Params,  # noqa: E402
                                            MPCParams, mpc_rollout)
from torch_robotics_tpu_torch.tasks import PlanningTask  # noqa: E402


def main(device: str = "cuda", batch: int = 16, n_steps: int = 150,
         horizon: int = 32, max_samples: int = 131072,
         seed: int = 0) -> dict:
    robots = [RobotPanda.create(device=device),
              RobotPanda.create(device=device), RobotUR10(device=device)]
    # base poses clear of the EnvSpheres3D obstacles: the spheres at
    # (0, +-0.3..0.45, *) would cut base-adjacent links of arms at +-0.45
    poses = [(z_rot(0.0, device=device), [0.2, 0.72, 0.0]),
             (z_rot(math.pi, device=device), [0.2, -0.72, 0.0]),
             (z_rot(0.0, device=device), [-0.75, 0.0, 0.0])]
    robot = MultiRobot.create(robots, [
        (R, torch.tensor(t, device=R.device)) for R, t in poses])
    task = PlanningTask(env=EnvSpheres3D(device=device), robot=robot,
                        obstacle_cutoff_margin=0.02)
    d = robot.q_dim
    print(f"{len(robots)} arms, q_dim={d}, "
          f"{len(robot.self_pair_idxs)} mutual/self collision pairs")
    # the joint 20-dof free space is a ~0.2% sliver of the limit box: a
    # large rejection budget
    gen = torch.Generator().manual_seed(seed)
    q0, n1 = task.random_coll_free_q(gen, n_samples=batch,
                                     max_samples=max_samples)
    qg, n2 = task.random_coll_free_q(gen, n_samples=batch,
                                     max_samples=max_samples)
    print(f"sampled {n1}/{batch} starts, {n2}/{batch} goals collision-free")
    start = torch.cat([q0, torch.zeros_like(q0)], -1)
    goal = torch.cat([qg, torch.zeros_like(qg)], -1)

    gp = GPMP2Params(n_support_points=horizon, dt=0.05, sigma_start=1e-3,
                     sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-3,
                     step_size=0.7)
    xs, info = mpc_rollout(task.collision_residuals, start, goal,
                           MPCParams(gpmp2=gp, iters_per_step=2),
                           n_steps=n_steps)
    d0 = float(torch.linalg.vector_norm(q0 - qg, dim=-1).mean())
    dist = info["dist_to_goal"][-1]
    n_near = int((dist < 0.3).sum())
    print(f"mean distance to goal {d0:.2f} -> {float(dist.mean()):.3f} rad "
          f"({d}-dof joint norm), {n_near}/{batch} within 0.3 rad")
    coll = task.compute_collision(xs, margin=0.0)
    frac_free = float((~coll.any(dim=-1)).float().mean())
    print(f"{frac_free * 100:.0f}% of executed rollouts contact-free "
          f"(environment + inter-arm)")
    return dict(n_starts=n1, n_goals=n2, mean_start_dist=d0,
                mean_final_dist=float(dist.mean()), n_within_0_3=n_near,
                fraction_contact_free=frac_free)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    main(args.device, args.batch, args.steps)
