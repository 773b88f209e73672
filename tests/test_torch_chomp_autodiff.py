"""CHOMP's autodiff branch (``solve/chomp.py``): residuals with no lanes
terms take autograd's gradient of lam sum 0.5 r^2.

- The planar 2-link arm in EnvPlanar2Link (whose task has no lanes path)
  against the JAX package's ``chomp_solve`` in float64: two lanes, H = 16,
  8 iterations; trajectories to 1e-8 of max|theta|, the cost trace to 1e-8
  relative.
- A Panda in EnvSpheres3D (tests/test_pallas_terms.py:201-221): the hook
  branch (lanes terms, value-only cost) against a plain residual function
  with ``supports_batch`` (autodiff, trace from the residuals), H = 16, 8
  iterations in float32, within 1e-5.
- A grid scene: the residuals' autograd gradient is the grid's surrogate
  gradient, so the two branches agree on it too (float64, 1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_robotics_tpu.envs import EnvPlanar2Link as JEnvPlanar2Link
from torch_robotics_tpu.robots import RobotPlanar2Link as JRobotPlanar2Link
from torch_robotics_tpu.solve.chomp import CHOMPParams as JCHOMPParams
from torch_robotics_tpu.solve.chomp import chomp_solve as jax_chomp_solve
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvPlanar2Link, EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPlanar2Link
from torch_robotics_tpu_torch.solve import (CHOMPParams, chomp_solve,
                                            straight_line_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL_F64 = 1e-8
TOL_BRANCHES = 1e-5


def plain_residuals(task):
    """The task's residuals without its hooks: the autodiff branch."""
    def plain(q):
        return task.collision_residuals(q)
    plain.supports_batch = True
    return plain


def test_planar2link_autodiff_matches_jax_in_float64():
    jtask = JPlanningTask(env=JEnvPlanar2Link(),
                          robot=JRobotPlanar2Link.create(),
                          obstacle_cutoff_margin=0.01)
    ptask = PlanningTask(env=EnvPlanar2Link(device="cpu"),
                         robot=RobotPlanar2Link.create(device="cpu"),
                         obstacle_cutoff_margin=0.01)
    assert ptask.collision_residuals.obstacle_terms_lanes is None
    start = np.array([[-np.pi / 2, 0.0, 0.0, 0.0], [-1.2, 0.3, 0.0, 0.0]])
    goal = np.array([[np.pi / 2 + 0.8, -0.4, 0.0, 0.0],
                     [1.9, -0.2, 0.0, 0.0]])
    params = CHOMPParams(n_support_points=16, dt=0.04, opt_iters=8,
                         sigma_coll=1e-3, sigma_start=1e-4, sigma_gp=2e-2,
                         sigma_goal=1e-4)
    theta0 = straight_line_trajs(torch.as_tensor(start),
                                 torch.as_tensor(goal), 16).numpy()
    with jax.enable_x64(True):
        jres = jax_chomp_solve(jtask.collision_residuals,
                               jnp.asarray(theta0), jnp.asarray(start),
                               jnp.asarray(goal),
                               JCHOMPParams(**params.__dict__))
        jt, jc = np.asarray(jres.trajs), np.asarray(jres.cost_trace)
    pres = chomp_solve(ptask.collision_residuals, torch.as_tensor(theta0),
                       torch.as_tensor(start), torch.as_tensor(goal), params)
    assert pres.trajs.dtype == torch.float64
    np.testing.assert_allclose(pres.trajs.numpy(), jt, rtol=0,
                               atol=TOL_F64 * np.abs(jt).max())
    np.testing.assert_allclose(pres.cost_trace.numpy(), jc, rtol=TOL_F64,
                               atol=TOL_F64 * np.abs(jc).max())
    assert float(jc.max()) > 0.0          # the obstacle is hit on the way


def test_panda_hook_branch_matches_autodiff():
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(device="cpu"),
                        obstacle_cutoff_margin=0.03)
    start = torch.zeros(14)
    goal = torch.cat([torch.full((7,), 0.5), torch.zeros(7)])
    theta0 = straight_line_trajs(start[None], goal[None], 16)
    p = CHOMPParams(n_support_points=16, opt_iters=8, sigma_coll=1e-2)
    res_hook = chomp_solve(task.collision_residuals, theta0, start, goal, p)
    res_ad = chomp_solve(plain_residuals(task), theta0, start, goal, p)
    np.testing.assert_allclose(res_hook.trajs.numpy(), res_ad.trajs.numpy(),
                               atol=TOL_BRANCHES)
    np.testing.assert_allclose(res_hook.cost_trace.numpy(),
                               res_ad.cost_trace.numpy(), rtol=TOL_BRANCHES)


def test_grid_scene_autodiff_matches_the_hook_in_float64():
    """EnvSpheres3D as a precomputed grid (cell 0.05): the surrogate
    gradient of the lookup is what autograd takes through the residuals."""
    task = PlanningTask(env=EnvSpheres3D(precompute_sdf_obj_fixed=True,
                                         sdf_cell_size=0.05, device="cpu"),
                        robot=RobotPanda.create(device="cpu"),
                        obstacle_cutoff_margin=0.03)
    rng = np.random.default_rng(3)
    start = np.concatenate([rng.uniform(-0.5, 0.5, (2, 7)),
                            np.zeros((2, 7))], -1)
    goal = np.concatenate([rng.uniform(-0.5, 0.5, (2, 7)),
                           np.zeros((2, 7))], -1)
    theta0 = straight_line_trajs(torch.as_tensor(start),
                                 torch.as_tensor(goal), 8)
    p = CHOMPParams(n_support_points=8, opt_iters=4)
    res_hook = chomp_solve(task.collision_residuals, theta0,
                           torch.as_tensor(start), torch.as_tensor(goal), p)
    res_ad = chomp_solve(plain_residuals(task), theta0,
                         torch.as_tensor(start), torch.as_tensor(goal), p)
    assert float(res_hook.cost_trace.max()) > 0.0
    ref = res_hook.trajs.numpy()
    np.testing.assert_allclose(res_ad.trajs.numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(res_ad.cost_trace.numpy(),
                               res_hook.cost_trace.numpy(), rtol=1e-10)
