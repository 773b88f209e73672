"""The port's MPOT (``solve/mpot.py``) and its MPOT -> GPMP2 pipeline
(``solve/hybrid.plan_mpot_gpmp2``) against the JAX package.

- ``polytope_vertices`` equal; ``_sinkhorn`` on random costs to 1e-6 of
  max|P| in float32 and 1e-12 in float64; ``MPOTParams.from_preset`` on
  EnvGridCircles2D's preset and EnvDense2D's tuned one equal to the JAX
  package's (and tests/test_solve_mpot.py's values).
- ``mpot_solve`` step for step in float64 on the JAX package's own
  rotations (``fold_in(key, it)`` then QR, computed here): 10 OT iterations
  with and without 10 clearance and 10 guarded smoothing steps, both
  couplings, on a point mass in EnvGridCircles2D with the clamped task as
  the guard: trajectories to 1e-8 of max|theta|, the cost trace to 1e-8 of
  its max.
- ``mpot_solve`` from its own generator keeps the endpoints pinned and
  lowers the cost (tests/test_solve_mpot.py:33); the pipeline's fallback
  polish keeps it at or above plain GPMP2 at the same budget
  (tests/test_hybrid.py:36).  The pipeline's quality floors
  (tests/test_solve_mpot.py:64) are in tests/test_torch_mpot_pipeline.py,
  a file of their own so that the two slow pipeline runs go to different
  test workers.

Run as a script, from the root of a checkout, to print the pipeline's
fraction free at the workload's size (B = 64, both scenes) through the JAX
package and through the port fed the JAX package's theta0 and rotations,
both in float32 on the CPU (a few minutes):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_mpot.py
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvGridCircles2D as JEnvGridCircles2D
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import mpot as jmpot
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvDense2D, EnvGridCircles2D
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPOTParams,
                                            gpmp2_init_trajs, gpmp2_solve,
                                            mpot_solve, plan_mpot_gpmp2,
                                            polytope_vertices,
                                            straight_line_trajs)
from torch_robotics_tpu_torch.solve.mpot import _mpot_solve_core, _sinkhorn
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL_F64 = 1e-8


@pytest.mark.parametrize("dim,kind", [(2, "cube"), (3, "cube"),
                                      (3, "orthoplex"), (14, "cube")])
def test_polytope_vertices_equal(dim, kind):
    got = polytope_vertices(dim, kind)
    np.testing.assert_array_equal(got, jmpot.polytope_vertices(dim, kind))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-12)


@pytest.mark.parametrize("shape", [(64, 4), (3, 16, 8)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_sinkhorn_matches_jax(shape, dtype, tol):
    C = np.random.default_rng(3).uniform(0.0, 2e-4, size=shape).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jmpot._sinkhorn(jnp.asarray(C), 0.01, 5))
    got = _sinkhorn(torch.as_tensor(C), 0.01, 5).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("env_name", ["EnvGridCircles2D", "EnvDense2D"])
def test_mpot_params_from_preset(env_name):
    envs = {"EnvGridCircles2D": (EnvGridCircles2D, JEnvGridCircles2D),
            "EnvDense2D": (EnvDense2D, JEnvDense2D)}
    env_t, env_j = envs[env_name]
    preset = env_t(device="cpu").get_mpot_params(
        RobotPointMass.create(device="cpu"))
    p = MPOTParams.from_preset(preset)
    ref = jmpot.MPOTParams.from_preset(
        env_j().get_mpot_params(JRobotPointMass.create()))
    assert dataclasses.asdict(p) == dataclasses.asdict(ref)
    if env_name == "EnvGridCircles2D":
        assert p.step_radius == pytest.approx(0.038)
        assert p.polytope == "cube"
        assert p.reg == pytest.approx(0.01)
        assert p.num_probe == 5
    else:
        assert p.opt_iters == 300
        assert p.step_radius == pytest.approx(0.07)
        assert p.probe_radius == pytest.approx(0.09)
        assert p.num_probe == 9


def _jax_rotations(n_iters, d, dtype):
    """The rotations JAX's mpot_solve draws with its default key."""
    key = jax.random.PRNGKey(0)
    return np.stack([np.asarray(jnp.linalg.qr(jax.random.normal(
        jax.random.fold_in(key, it), (d, d), dtype))[0])
        for it in range(n_iters)])


@pytest.fixture(scope="module")
def grid_problem():
    """Four GP-prior trajectories (H = 24) on GridCircles2D, numpy."""
    H = 24
    start = np.array([-0.75, -0.75, 0.0, 0.0])
    goal = np.array([0.75, 0.75, 0.0, 0.0])
    gp = GPMP2Params(n_support_points=H, sigma_gp_init=0.2)
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(2), gp,
                              torch.as_tensor(start), torch.as_tensor(goal),
                              num_samples=4).double().numpy()
    return theta0, start, goal


@pytest.mark.parametrize("smooth_iters,coupling", [
    (0, "full"), (10, "full"), (10, "trajectory")])
def test_mpot_step_for_step_in_float64(grid_problem, smooth_iters, coupling):
    theta0, start, goal = grid_problem
    p = dict(opt_iters=10, smooth_iters=max(smooth_iters, 1),
             w_smooth=1e-7 if smooth_iters else 0.0, sigma_start=1e-3,
             sigma_goal=1e-3, coupling=coupling)
    with jax.enable_x64(True):
        jtask = JPlanningTask(env=JEnvGridCircles2D(),
                              robot=JRobotPointMass.create(),
                              obstacle_cutoff_margin=0.01)
        jtask_h = JPlanningTask(env=jtask.env, robot=jtask.robot,
                                obstacle_cutoff_margin=0.01,
                                clamp_sdf_cost=True)
        Q = _jax_rotations(10, 2, jnp.float64)
        ref = jmpot.mpot_solve(
            lambda th: jtask._compute_cost(th[..., :2]), jnp.asarray(theta0),
            jnp.asarray(start), jnp.asarray(goal), jmpot.MPOTParams(**p),
            hinge_cost_fn=lambda th: jtask_h._compute_cost(th[..., :2]))
        ref_trajs = np.asarray(ref.trajs)
        ref_trace = np.asarray(ref.cost_trace)
    env, robot = (EnvGridCircles2D(device="cpu"),
                  RobotPointMass.create(device="cpu"))
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01)
    task_h = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01,
                          clamp_sdf_cost=True)
    got = _mpot_solve_core(
        lambda th: task._compute_cost(th[..., :2]), torch.as_tensor(theta0),
        torch.as_tensor(start), torch.as_tensor(goal), MPOTParams(**p),
        torch.as_tensor(Q),
        hinge_cost_fn=lambda th: task_h._compute_cost(th[..., :2]))
    assert got.trajs.dtype == torch.float64
    np.testing.assert_allclose(got.cost_trace.numpy(), ref_trace,
                               atol=TOL_F64 * np.abs(ref_trace).max())
    np.testing.assert_allclose(got.trajs.numpy(), ref_trajs,
                               atol=TOL_F64 * np.abs(ref_trajs).max())


def test_mpot_solve_pins_endpoints_and_lowers_cost():
    env, robot = (EnvGridCircles2D(device="cpu"),
                  RobotPointMass.create(device="cpu"))
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01)
    params = MPOTParams.from_preset({**env.get_mpot_params(robot),
                                     "opt_iters": 60, "sigma_start": 1e-3,
                                     "sigma_goal": 1e-3})

    def state_cost(theta):
        return task._compute_cost(theta[..., :2])

    start = torch.tensor([-0.9, -0.9, 0.0, 0.0])
    goal = torch.tensor([0.9, 0.9, 0.0, 0.0])
    theta0 = straight_line_trajs(start, goal, 64)[None].repeat(4, 1, 1)
    res = mpot_solve(state_cost, theta0, start, goal, params,
                     generator=torch.Generator().manual_seed(0))
    assert res.trajs.shape == theta0.shape
    assert res.cost_trace.shape == (60, 4)
    assert bool(torch.isfinite(res.trajs).all())
    np.testing.assert_allclose(res.trajs[:, 0, :2],
                               np.tile([-0.9, -0.9], (4, 1)), atol=0.05)
    np.testing.assert_allclose(res.trajs[:, -1, :2],
                               np.tile([0.9, 0.9], (4, 1)), atol=0.05)
    assert float(state_cost(res.trajs).sum()) < float(state_cost(theta0).sum())


def test_fallback_polish_not_below_plain_gpmp2():
    env, robot = EnvDense2D(device="cpu"), RobotPointMass.create(device="cpu")
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01)
    start = torch.tensor([-0.9, -0.9, 0.0, 0.0])
    goal = torch.tensor([0.9, 0.9, 0.0, 0.0])
    gp = dataclasses.replace(
        GPMP2Params.from_preset(env.get_gpmp2_params(robot)), num_samples=16)
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(0), gp, start,
                              goal)
    m = MPOTParams(sigma_start=1e-3, sigma_goal=1e-3, w_coll=7e-3,
                   opt_iters=30, smooth_iters=10)
    res_p, _ = plan_mpot_gpmp2(task, theta0, start, goal, mpot_params=m,
                               gpmp2_params=gp, polish_iters=50)
    res_g = gpmp2_solve(task.collision_residuals, theta0, start, goal,
                        dataclasses.replace(gp, opt_iters=50))
    free_p = task.compute_fraction_free_trajs(res_p.trajs[..., :2])
    free_g = task.compute_fraction_free_trajs(res_g.trajs[..., :2])
    assert free_p >= free_g - 1e-6, (free_p, free_g)


def pipeline_on_jax_inputs(name, start_q, goal_q):
    """The MPOT -> GPMP2 workload (benchmarks/mpot_vs_gpmp2.py: B = 64,
    cutoff 0.01, the scene's presets, a 50-iteration polish) through the
    JAX package's ``plan_mpot_gpmp2``, and through the port's stages fed
    JAX's theta0 and rotations: fraction free after each stage."""
    from torch_robotics_tpu.envs import make_env as jax_make_env
    from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
    from torch_robotics_tpu.solve import gpmp2_init_trajs as jax_init
    from torch_robotics_tpu.solve.hybrid import plan_mpot_gpmp2 as jax_plan
    from torch_robotics_tpu_torch.envs import make_env
    jenv, jrobot = jax_make_env(name), JRobotPointMass.create()
    jtask = JPlanningTask(env=jenv, robot=jrobot, obstacle_cutoff_margin=0.01)
    start = np.array(start_q + (0.0, 0.0), np.float32)
    goal = np.array(goal_q + (0.0, 0.0), np.float32)
    jgp = dataclasses.replace(
        JGPMP2Params.from_preset(jenv.get_gpmp2_params(jrobot)),
        num_samples=64)
    jmp = jmpot.MPOTParams.from_preset({**jenv.get_mpot_params(jrobot),
                                        "sigma_start": 1e-3,
                                        "sigma_goal": 1e-3})
    theta0 = jax_init(jax.random.PRNGKey(0), jgp, jnp.asarray(start),
                      jnp.asarray(goal))
    j_res, j_mpot = jax_plan(jtask, theta0, jnp.asarray(start),
                             jnp.asarray(goal), mpot_params=jmp,
                             gpmp2_params=jgp, polish_iters=50)
    env = make_env(name, device="cpu")
    robot = RobotPointMass.create(device="cpu")
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01)
    task_h = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01,
                          clamp_sdf_cost=True)
    th0 = torch.as_tensor(np.array(theta0))
    s, g = torch.as_tensor(start), torch.as_tensor(goal)
    Q = _jax_rotations(jmp.opt_iters, 2, jnp.float32)
    p_mpot = _mpot_solve_core(
        lambda th: task._compute_cost(th[..., :2]), th0, s, g,
        MPOTParams(**dataclasses.asdict(jmp)), torch.as_tensor(Q),
        hinge_cost_fn=lambda th: task_h._compute_cost(th[..., :2]))
    polish = GPMP2Params(**dict(dataclasses.asdict(jgp), opt_iters=50))
    free = ~task.trajs_collision_masks(gpmp2_solve(
        task.collision_residuals, p_mpot.trajs, s, g, polish).trajs)[0]
    free_fb = ~task.trajs_collision_masks(gpmp2_solve(
        task.collision_residuals, th0, s, g, polish).trajs)[0]
    return {"jax": {"after_mpot": jtask.compute_fraction_free_trajs(
                        j_mpot.trajs),
                    "after_pipeline": jtask.compute_fraction_free_trajs(
                        j_res.trajs)},
            "port_on_jax_inputs": {
                "after_mpot": task.compute_fraction_free_trajs(p_mpot.trajs),
                "after_pipeline": float((free | free_fb).float().mean())}}


if __name__ == "__main__":
    print(json.dumps({
        "EnvGridCircles2D": pipeline_on_jax_inputs(
            "EnvGridCircles2D", (-0.75, -0.75), (0.75, 0.75)),
        "EnvDense2D": pipeline_on_jax_inputs(
            "EnvDense2D", (-0.9, -0.9), (0.9, 0.9))}))
