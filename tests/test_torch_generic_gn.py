"""The port's generic residuals (``tasks/planning_task.CollisionResiduals``
for a robot with no lanes path) and its generic Gauss-Newton step
(``solve/gpmp2._gpmp2_step_impl``) against the JAX package.

- Planar2Link's residuals and ``residuals_and_jacobian`` (rows: 12 object
  SDF rows, 12 workspace rows with ws_dim 2) on a batch and on one q: in
  float32 to 1e-6 of max|ref| of the JAX package's function (its float64
  run), in float64 to 1e-12; the analytic Jacobians match
  ``torch.func.jacfwd`` of the residuals.  The task has no
  lanes terms and no lanes cost, and K1's and K8's factories return None
  for it.
- One generic GN step in float64 to 1e-9 of max|theta|: Planar2Link at
  (B, H, m), one (H, m) trajectory, a residual function without
  ``residuals_and_jacobian`` (jacfwd on both sides), the point mass at two
  batch dims (a lanes task whose theta is not (B, H, m)), and a state
  block m = 34 > 32 (the batch-major solve).
- tests/test_planar2link_task.py's 60-iteration solve (H = 32, B = 8) in
  float64: trajectories and the cost trace to 1e-8 of their max, and the
  mean cost lower at the end than at the start, in float32 too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvPlanar2Link as JEnvPlanar2Link
from torch_robotics_tpu.robots import RobotPlanar2Link as JRobotPlanar2Link
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve import gpmp2_solve as jax_gpmp2_solve
from torch_robotics_tpu.solve.gpmp2 import gpmp2_step as jax_gpmp2_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvDense2D, EnvPlanar2Link
from torch_robotics_tpu_torch.ops.terms_kernel import (
    collision_cost_kernel_factory, obstacle_terms_kernel_factory)
from torch_robotics_tpu_torch.robots import RobotPlanar2Link, RobotPointMass
from torch_robotics_tpu_torch.solve import (GPMP2Params, gpmp2_init_trajs,
                                            gpmp2_solve, gpmp2_step)
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL_F32 = 1e-6
TOL_STEP_F64 = 1e-9
TOL_SOLVE_F64 = 1e-8
# tests/test_planar2link_task.py:47-52
P2L = dict(n_support_points=32, dt=0.04, opt_iters=60, sigma_coll=1e-3,
           sigma_start=1e-4, sigma_goal_prior=1e-4, sigma_gp=2e-2,
           step_size=0.5, num_samples=8, sigma_gp_init=0.1)
P2L_START = (-np.pi / 2, 0.0, 0.0, 0.0)
P2L_GOAL = (np.pi / 2 + 0.8, -0.4, 0.0, 0.0)


def _close(got, ref, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


def _tasks(name, f64=False):
    """(port task, JAX task) for the planar arm or the point mass."""
    with jax.enable_x64(f64):
        if name == "planar2link":
            return (PlanningTask(env=EnvPlanar2Link(device="cpu"),
                                 robot=RobotPlanar2Link.create(device="cpu"),
                                 obstacle_cutoff_margin=0.01),
                    JPlanningTask(env=JEnvPlanar2Link(),
                                  robot=JRobotPlanar2Link.create(),
                                  obstacle_cutoff_margin=0.01))
        return (PlanningTask(env=EnvDense2D(device="cpu"),
                             robot=RobotPointMass.create(device="cpu"),
                             obstacle_cutoff_margin=0.02),
                JPlanningTask(env=JEnvDense2D(),
                              robot=JRobotPointMass.create(),
                              obstacle_cutoff_margin=0.02))


@pytest.fixture(scope="module")
def p2l():
    return _tasks("planar2link")


def _q(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, size=(n, 2)).astype(np.float32)


def test_generic_task_has_no_lanes_hooks(p2l):
    task, _ = p2l
    cr = task.collision_residuals
    assert cr.obstacle_terms_lanes is None
    assert cr.collision_cost_lanes is None
    assert cr.residuals_and_jacobian is not None
    assert obstacle_terms_kernel_factory(task) is None
    assert collision_cost_kernel_factory(task) is None


@pytest.mark.parametrize("batch", [True, False])
def test_generic_residuals_match_jax(batch):
    """The port's float32 rows against the JAX package's function
    (evaluated in float64) to 1e-6 of max|ref|, and the two packages in
    float64 to 1e-12.  (A deep-penetration row's float32 Jacobian is off
    float64 by ~4e-7 of max|J| in JAX's autodiff of the sphere SDF and by
    ~2.5e-7 in the port's analytic gradient: the two float32 results can
    differ by more than 1e-6 of max|J| without either being wrong.)"""
    q = _q(256) if batch else _q(1)[0]
    task, _ = _tasks("planar2link")
    _, jtask = _tasks("planar2link", f64=True)
    with jax.enable_x64(True):
        jq = jnp.asarray(q, jnp.float64)
        jfn = jtask.collision_residuals
        jr, jJ = jax.jit(jfn.residuals_and_jacobian)(jq)
        jres = jax.jit(jax.vmap(jfn) if batch else jfn)(jq)
        jr, jJ, jres = np.asarray(jr), np.asarray(jJ), np.asarray(jres)
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, 1e-12)):
        qt = torch.as_tensor(q, dtype=dtype)
        r = task.collision_residuals(qt)
        r2, J = task.collision_residuals.residuals_and_jacobian(qt)
        assert r.shape[-1] == 24 and J.dtype == dtype
        _close(r, jres, tol)
        _close(r2, jr, tol)
        _close(J, jJ, tol)
    if batch:
        assert 0 < int((jr > 0).sum()) < jr.size


def test_generic_jacobian_matches_jacfwd(p2l):
    task, _ = p2l
    q = torch.as_tensor(_q(64, seed=4))
    cr = task.collision_residuals
    _, J = cr.residuals_and_jacobian(q)
    _close(J, torch.func.vmap(torch.func.jacfwd(cr))(q), TOL_F32)


def _problem(name, batch, H, seed=1):
    """theta0 (batch..., H, 4), start, goal as float64 numpy."""
    if name == "planar2link":
        start, goal = np.array(P2L_START), np.array(P2L_GOAL)
    else:
        start = np.array([-0.9, -0.9, 0.0, 0.0])
        goal = np.array([0.9, 0.9, 0.0, 0.0])
    n = int(np.prod(batch)) if batch else 1
    gp = GPMP2Params(**dict(P2L, n_support_points=H))
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(seed), gp,
                              torch.as_tensor(start), torch.as_tensor(goal),
                              num_samples=n).double().numpy()
    return theta0.reshape(tuple(batch) + (H, 4)), start, goal


def _no_jacobian(fn):
    """fn without its attributes: the step falls back to jacfwd."""
    return lambda q: fn(q)


@pytest.mark.parametrize("name,batch,plain_fn", [
    ("planar2link", (4,), False), ("planar2link", (), False),
    ("planar2link", (3,), True), ("point_mass", (2, 3), False)])
def test_generic_step_matches_jax_in_float64(name, batch, plain_fn):
    theta0, start, goal = _problem(name, batch, 16)
    params = dict(P2L, n_support_points=16)
    task, jtask = _tasks(name, f64=True)
    with jax.enable_x64(True):
        jfn = jtask.collision_residuals
        if plain_fn:
            jfn = _no_jacobian(jfn)
        ref, jcost = jax.jit(lambda th: jax_gpmp2_step(
            jfn, th, jnp.asarray(start), jnp.asarray(goal),
            JGPMP2Params(**params)))(jnp.asarray(theta0))
        ref, jcost = np.asarray(ref), np.asarray(jcost)
    fn = task.collision_residuals
    got, cost = gpmp2_step(_no_jacobian(fn) if plain_fn else fn,
                           torch.as_tensor(theta0), torch.as_tensor(start),
                           torch.as_tensor(goal), GPMP2Params(**params))
    assert got.dtype == torch.float64
    _close(got, ref, TOL_STEP_F64)
    _close(cost, jcost, TOL_STEP_F64)


def test_generic_step_wide_state_matches_jax_in_float64():
    """m = 34 > 32: the batch-major solve, on a hinge residual q -> relu(
    0.3 - q) of 17 joints."""
    d, H, B = 17, 8, 3
    rng = np.random.default_rng(5)
    theta0 = rng.uniform(-0.5, 0.5, size=(B, H, 2 * d))
    start, goal = theta0[0, 0] * 0, theta0[0, -1] * 0 + 0.4
    params = dict(n_support_points=H, dt=0.1, sigma_coll=1e-2,
                  sigma_start=1e-3, sigma_goal_prior=1e-3, sigma_gp=0.1,
                  step_size=0.5)
    with jax.enable_x64(True):
        ref, _ = jax_gpmp2_step(lambda q: jax.nn.relu(0.3 - q),
                                jnp.asarray(theta0), jnp.asarray(start),
                                jnp.asarray(goal), JGPMP2Params(**params))
        ref = np.asarray(ref)
    got, _ = gpmp2_step(lambda q: torch.relu(0.3 - q),
                        torch.as_tensor(theta0), torch.as_tensor(start),
                        torch.as_tensor(goal), GPMP2Params(**params))
    _close(got, ref, TOL_STEP_F64)


@pytest.fixture(scope="module")
def p2l_solve_f64():
    theta0, start, goal = _problem("planar2link", (8,), 32)
    task, jtask = _tasks("planar2link", f64=True)
    with jax.enable_x64(True):
        ref = jax_gpmp2_solve(jtask.collision_residuals, jnp.asarray(theta0),
                              jnp.asarray(start), jnp.asarray(goal),
                              JGPMP2Params(**P2L))
        ref = (np.asarray(ref.trajs), np.asarray(ref.cost_trace))
    res = gpmp2_solve(task.collision_residuals, torch.as_tensor(theta0),
                      torch.as_tensor(start), torch.as_tensor(goal),
                      GPMP2Params(**P2L))
    return res, ref, (theta0, start, goal)


def test_planar2link_solve_matches_jax_in_float64(p2l_solve_f64):
    res, (ref_trajs, ref_trace), _ = p2l_solve_f64
    assert res.cost_trace.shape == (60, 8)
    _close(res.trajs, ref_trajs, TOL_SOLVE_F64)
    _close(res.cost_trace, ref_trace, TOL_SOLVE_F64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planar2link_solve_lowers_cost(p2l_solve_f64, dtype):
    res, _, (theta0, start, goal) = p2l_solve_f64
    if dtype == torch.float32:
        task, _ = _tasks("planar2link")
        res = gpmp2_solve(task.collision_residuals,
                          torch.as_tensor(theta0, dtype=dtype),
                          torch.as_tensor(start, dtype=dtype),
                          torch.as_tensor(goal, dtype=dtype),
                          GPMP2Params(**P2L))
    assert res.trajs.dtype == dtype
    assert bool(torch.isfinite(res.trajs).all())
    assert float(res.cost_trace[-1].mean()) <= float(res.cost_trace[0].mean())


def test_refactor_every_warns_on_the_generic_path(p2l):
    task, _ = p2l
    theta0, start, goal = _problem("planar2link", (2,), 8)
    params = dataclasses.replace(GPMP2Params(**dict(P2L, n_support_points=8)),
                                 opt_iters=2, refactor_every=2)
    with pytest.warns(UserWarning, match="refactor_every=2 is ignored"):
        res = gpmp2_solve(task.collision_residuals,
                          torch.as_tensor(theta0, dtype=torch.float32),
                          torch.as_tensor(start, dtype=torch.float32),
                          torch.as_tensor(goal, dtype=torch.float32), params)
    assert res.cost_trace.shape == (2, 2)
