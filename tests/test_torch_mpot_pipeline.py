"""The port's MPOT -> GPMP2 pipeline (``solve/hybrid.plan_mpot_gpmp2``)
meets tests/test_solve_mpot.py:64's floors on a point mass in
EnvGridCircles2D: 16 samples, a 30-iteration polish, at least 0.4 of the
trajectories free, mean smoothness under 12, the endpoints pinned to 2e-2.

It is the slowest single case of the port's CPU tests, so it has a file of
its own, apart from the rest of tests/test_torch_mpot.py.
"""
import numpy as np
import torch

from torch_robotics_tpu_torch.envs import EnvGridCircles2D
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import (GPMP2Params, gpmp2_init_trajs,
                                            plan_mpot_gpmp2)
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.trajectory import compute_smoothness


def test_mpot_gpmp2_pipeline_quality():
    env, robot = (EnvGridCircles2D(device="cpu"),
                  RobotPointMass.create(device="cpu"))
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01)
    start = torch.tensor([-0.75, -0.75, 0.0, 0.0])
    goal = torch.tensor([0.75, 0.75, 0.0, 0.0])
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(0),
                              GPMP2Params(num_samples=16, sigma_gp_init=0.2),
                              start, goal)
    stats = {}
    res, res_mpot = plan_mpot_gpmp2(task, theta0, start, goal,
                                    polish_iters=30, stats=stats)
    assert res.trajs.shape == theta0.shape == res_mpot.trajs.shape
    assert set(stats) == {"mpot_s", "polish_s", "fallback_s",
                          "fallback_ran"}
    assert task.compute_fraction_free_trajs(res.trajs) >= 0.4
    assert float(compute_smoothness(res.trajs, robot).mean()) < 12.0
    np.testing.assert_allclose(res.trajs[:, 0, :2],
                               np.tile([-0.75, -0.75], (16, 1)), atol=2e-2)
    np.testing.assert_allclose(res.trajs[:, -1, :2],
                               np.tile([0.75, 0.75], (16, 1)), atol=2e-2)
