"""GPMP2 trajectory optimization: the point mass in EnvDense2D
(counterpart of examples/planning_point_mass.py).

    python -m torch_robotics_tpu_torch.examples.planning_point_mass
    python torch_robotics_tpu_torch/examples/planning_point_mass.py \\
        [--device cpu]

A batched GPMP2 solve from samples of the GP prior with the scene's
preset, then the collision / free split and the metrics.  Runs on the
card unless ``--device cpu`` is given.  The reference's plot of the
trajectories is left out: it needs ``viz/``, which the port does not
have.
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from torch_robotics_tpu_torch.envs import EnvDense2D  # noqa: E402
from torch_robotics_tpu_torch.robots import RobotPointMass  # noqa: E402
from torch_robotics_tpu_torch.solve import (GPMP2Params,  # noqa: E402
                                            gpmp2_init_trajs, gpmp2_solve)
from torch_robotics_tpu_torch.tasks import PlanningTask  # noqa: E402
from torch_robotics_tpu_torch.trajectory import (  # noqa: E402
    compute_path_length, compute_smoothness)


def main(device: str = "cuda", seed: int = 2, num_samples=None,
         opt_iters=None) -> dict:
    env = EnvDense2D(device=device)
    robot = RobotPointMass.create(device=device)
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.02)
    params = GPMP2Params.from_preset(env.get_gpmp2_params(robot))
    if num_samples is not None:
        params = dataclasses.replace(params, num_samples=num_samples)
    if opt_iters is not None:
        params = dataclasses.replace(params, opt_iters=opt_iters)
    start = torch.tensor([-0.9, -0.9, 0.0, 0.0], device=robot.q_min.device)
    goal = torch.tensor([0.9, 0.9, 0.0, 0.0], device=robot.q_min.device)
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(seed), params,
                              start, goal)
    result = gpmp2_solve(task.collision_residuals, theta0, start, goal,
                         params)

    trajs = result.trajs
    frac_free = task.compute_fraction_free_trajs(trajs)
    _, free = task.get_trajs_collision_and_free(trajs)
    path_length = float(compute_path_length(trajs, robot).mean())
    smoothness = float(compute_smoothness(trajs, robot).mean())
    print(f"solved {trajs.shape[0]} trajectories, "
          f"{frac_free * 100:.0f}% collision-free")
    print("path length (mean):", path_length)
    print("smoothness (mean):", smoothness)
    return dict(n_trajs=trajs.shape[0], fraction_free=frac_free,
                n_free=0 if free is None else free.shape[0],
                collision_intensity=task.compute_collision_intensity_trajs(
                    trajs),
                success=task.compute_success_free_trajs(trajs),
                path_length=path_length, smoothness=smoothness)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    main(args.device, args.seed)
