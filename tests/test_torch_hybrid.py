"""The port's hybrid planner (``solve/hybrid.py``) against the JAX package.

- The seed of the refinement batch (the RRT path through the clamped
  spline with the average velocity, or the straight line, plus ramped
  jitter) matches the construction inside JAX's ``plan_hybrid`` on the
  same path and the same standard normals: 1e-6 of max|theta| in float32,
  1e-10 in float64.
- ``plan_hybrid`` on tests/test_hybrid.py's narrow-passage problem meets
  that test's assertions (a path, finite trajectories, at least half of
  them free, endpoints within 2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.solve.gp_prior import \
    straight_line_trajs as jax_straight_line
from torch_robotics_tpu.trajectory.utils import \
    smoothen_trajectory as jax_smoothen
from torch_robotics_tpu_torch.envs import (EnvDense2D,
                                           EnvNarrowPassageDense2D)
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import (GPMP2Params, RRTConnectParams,
                                            plan_hybrid)
from torch_robotics_tpu_torch.solve.hybrid import _hybrid_seed
from torch_robotics_tpu_torch.tasks import PlanningTask


def jax_seed(path, start_q, goal_q, H, dt, normals, noise_scale):
    """torch_robotics_tpu/solve/hybrid.py:51-67 on given normals."""
    d = start_q.shape[-1]
    if path is not None:
        pos, vel = jax_smoothen(jnp.asarray(path), n_support_points=H, dt=dt,
                                set_average_velocity=True)
        theta_init = jnp.concatenate([pos, vel], axis=-1)
    else:
        theta_init = jax_straight_line(
            jnp.concatenate([start_q, jnp.zeros(d)]),
            jnp.concatenate([goal_q, jnp.zeros(d)]), H)
    noise = jnp.asarray(normals, theta_init.dtype) * noise_scale
    ramp = jnp.minimum(jnp.linspace(0, 1, H), jnp.linspace(1, 0, H))
    return np.asarray(theta_init[None] + noise * ramp[:, None])


@pytest.mark.parametrize("with_path", [True, False])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-10)])
def test_seed_matches_jax_on_shared_normals(with_path, dtype, tol):
    rng = np.random.default_rng(11)
    H, n = 48, 6
    start, goal = np.array([-0.9, 0.0], dtype), np.array([0.9, 0.0], dtype)
    path = None
    if with_path:
        mid = rng.uniform(-0.5, 0.5, size=(7, 2))
        path = np.concatenate([start[None], mid, goal[None]]).astype(dtype)
    normals = rng.normal(size=(n, H, 4)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = jax_seed(path, jnp.asarray(start), jnp.asarray(goal), H, 0.04,
                       normals, 0.02)
    got = _hybrid_seed(path, torch.as_tensor(start), torch.as_tensor(goal),
                       H, 0.04, torch.as_tensor(normals), 0.02)
    assert got.dtype == torch.as_tensor(normals).dtype
    assert tuple(got.shape) == ref.shape == (n, H, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_plan_hybrid_narrow_passage():
    """tests/test_hybrid.py:11 on the port (CPU)."""
    env = EnvNarrowPassageDense2D(device="cpu")
    robot = RobotPointMass.create(device="cpu")
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.005)
    gp = GPMP2Params(n_support_points=48, dt=0.04, opt_iters=200,
                     sigma_coll=1e-4, sigma_start=1e-4, sigma_goal_prior=1e-4,
                     sigma_gp=2e-2, step_size=0.2)
    rrt = RRTConnectParams(n_iters=4000, n_radius=0.25, n_pre_samples=4096,
                           max_time=60.0)
    start = torch.tensor([-0.9, 0.0])
    goal = torch.tensor([0.9, 0.0])
    stats = {}
    result, path = plan_hybrid(task, start, goal, gpmp2_params=gp,
                               rrt_params=rrt, num_samples=4, stats=stats)
    assert path is not None, "RRT failed in the narrow passage"
    assert bool(torch.isfinite(result.trajs).all())
    frac_free = task.compute_fraction_free_trajs(result.trajs)
    assert frac_free >= 0.5, \
        f"hybrid refinement lost the passage ({frac_free})"
    np.testing.assert_allclose(result.trajs[:, 0, :2].numpy(),
                               np.tile(start.numpy(), (4, 1)), atol=2e-2)
    np.testing.assert_allclose(result.trajs[:, -1, :2].numpy(),
                               np.tile(goal.numpy(), (4, 1)), atol=2e-2)
    assert tuple(result.cost_trace.shape) == (200, 4)
    assert stats["n_checks"] > 0 and stats["rrt_s"] > 0


def test_plan_hybrid_takes_the_scene_presets():
    """Without rrt_params: the scene's RRT-Connect preset (EnvDense2D has
    one for the point mass); the result's horizon is the GPMP2 preset's."""
    env = EnvDense2D(device="cpu")
    task = PlanningTask(env=env, robot=RobotPointMass.create(device="cpu"),
                        obstacle_cutoff_margin=0.02)
    preset = GPMP2Params.from_preset(env.get_gpmp2_params(task.robot))
    gp = dataclasses.replace(preset, opt_iters=3)
    result, path = plan_hybrid(task, [-0.9, -0.9], [0.9, 0.9],
                               gpmp2_params=gp, num_samples=2)
    assert path is not None
    assert tuple(result.trajs.shape) == (2, preset.n_support_points, 4)
