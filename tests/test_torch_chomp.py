"""The port's batch-major block-tridiagonal solvers (``solve/btridiag.py``,
``block_tridiag_solve_lanes``) and CHOMP (``solve/chomp.py``) against the
JAX package.

- In float64 every solver computes the reference's function: the factors,
  the factored solve, the fused solve, the log-determinant and the lanes
  solve (also with a D and U shared over the batch) to 1e-10 of max|ref|.
- CHOMP in float64 on the point mass (tests/test_solve_other.py:37's
  problem: 100 iterations) and on a small Panda problem (2 x 2 problems, H
  = 8, 6 iterations, the terms and the cost through the plain hooks that
  the kernels replace on the card): trajectories to 1e-8 of max|theta|,
  the cost trace to 1e-8 relative; ``per_problem_trace`` keeps the batch
  axes.  The preconditioning solve on both sides of the m = 32 split
  (lanes layout, batch-major) against the reference's solver there.
- CHOMP's autodiff branch on tanh residuals (batched and vmapped) to the
  same 1e-8; residuals with no gradient raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import btridiag as jbt
from torch_robotics_tpu.solve.btridiag_lanes import \
    block_tridiag_solve_lanes as jax_solve_lanes
from torch_robotics_tpu.solve.chomp import CHOMPParams as JCHOMPParams
from torch_robotics_tpu.solve.chomp import chomp_solve as jax_chomp_solve
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.solve import (CHOMPParams,
                                            block_tridiag_cholesky,
                                            block_tridiag_logdet,
                                            block_tridiag_solve,
                                            block_tridiag_solve_factored,
                                            block_tridiag_solve_lanes,
                                            chomp_solve, straight_line_trajs)
from torch_robotics_tpu_torch.solve.chomp import _precondition
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL_SOLVE = 1e-10
TOL_CHOMP = 1e-8


def spd_system(H, m, batch=(), seed=0):
    """Random SPD block-tridiagonal system (float64 numpy): D, U, b."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=batch + (H, m, m)) * 0.3
    D = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m)
    U = rng.normal(size=batch + (H - 1, m, m)) * 0.2
    b = rng.normal(size=batch + (H, m))
    return D, U, b


def close(got, ref, tol=TOL_SOLVE):
    ref = np.asarray(ref)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("H,m,batch", [(12, 4, ()), (8, 3, (5,)),
                                       (6, 14, (2, 3)), (3, 16, (2,))])
def test_batch_major_solvers_match_jax_in_float64(H, m, batch):
    D, U, b = spd_system(H, m, batch, seed=H + m)
    with jax.enable_x64(True):
        jLd, jLo = jbt.block_tridiag_cholesky(jnp.asarray(D), jnp.asarray(U))
        jx_f = jbt.block_tridiag_solve_factored(jLd, jLo, jnp.asarray(b))
        jx = jbt.block_tridiag_solve(jnp.asarray(D), jnp.asarray(U),
                                     jnp.asarray(b))
        jld = jbt.block_tridiag_logdet(jLd)
        jx_l = jax_solve_lanes(jnp.asarray(D), jnp.asarray(U),
                               jnp.asarray(b))
    Ld, Lo = block_tridiag_cholesky(t(D), t(U))
    close(Ld, jLd)
    close(Lo, jLo)
    close(block_tridiag_solve_factored(Ld, Lo, t(b)), jx_f)
    close(block_tridiag_solve(t(D), t(U), t(b)), jx)
    close(block_tridiag_logdet(Ld), jld)
    close(block_tridiag_solve_lanes(t(D), t(U), t(b)), jx_l)


@pytest.mark.parametrize("solver", ["fused", "lanes"])
def test_shared_blocks_broadcast_against_a_batch_of_rhs(solver):
    """D, U without batch dims against b (4, H, m): the reference's
    broadcasting (a shared prior Hessian, as CHOMP preconditions with)."""
    D, U, _ = spd_system(10, 6, seed=3)
    b = np.random.default_rng(4).normal(size=(4, 10, 6))
    jfn = jbt.block_tridiag_solve if solver == "fused" else jax_solve_lanes
    fn = block_tridiag_solve if solver == "fused" else \
        block_tridiag_solve_lanes
    with jax.enable_x64(True):
        ref = jfn(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b))
    close(fn(t(D), t(U), t(b)), ref)


def test_indefinite_pivot_gives_nan_not_an_error():
    D, U, b = spd_system(4, 3, seed=5)
    D[2] = -np.eye(3)
    x = block_tridiag_solve(t(D), t(U), t(b))
    assert bool(torch.isnan(x).any())


@pytest.mark.parametrize("m", [4, 34])
def test_precondition_matches_the_reference_solver(m):
    """m <= 32: the lanes solve (the sweep kernel on the card); m > 32:
    batch-major, as the reference splits at _LANES_SOLVE_MAX_M."""
    D, U, _ = spd_system(8, m, seed=m)
    g = np.random.default_rng(m).normal(size=(3, 8, m))
    jfn = jbt.block_tridiag_solve if m > 32 else jax_solve_lanes
    with jax.enable_x64(True):
        ref = jfn(jnp.asarray(D) + 1e-6 * jnp.eye(m), jnp.asarray(U),
                  jnp.asarray(g))
    close(_precondition(t(D), t(U), t(g)), ref)


@pytest.fixture(scope="module")
def pm_tasks():
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01)
    ptask = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=0.01)
    return jtask, ptask


def run_both(jtask, ptask, theta0, start, goal, params, per_problem=False):
    """float64 CHOMP through both packages -> (jax (trajs, trace), port)."""
    with jax.enable_x64(True):
        jres = jax_chomp_solve(jtask.collision_residuals,
                               jnp.asarray(theta0), jnp.asarray(start),
                               jnp.asarray(goal),
                               JCHOMPParams(**params.__dict__),
                               per_problem_trace=per_problem)
        jres = (np.asarray(jres.trajs), np.asarray(jres.cost_trace))
    pres = chomp_solve(ptask.collision_residuals, t(theta0), t(start),
                       t(goal), params, per_problem_trace=per_problem)
    return jres, pres


def hold(jres, pres):
    (jt, jc), (pt, pc) = jres, pres
    close(pt, jt, TOL_CHOMP)
    assert pc.dtype == torch.float64 and tuple(pc.shape) == jc.shape
    np.testing.assert_allclose(pc.numpy(), jc, rtol=TOL_CHOMP,
                               atol=TOL_CHOMP * np.abs(jc).max())


def test_chomp_point_mass_matches_jax_in_float64(pm_tasks):
    """tests/test_solve_other.py:37: 4 straight lines, H = 32, 100
    iterations; the cost trace falls, the start stays put."""
    start = np.array([-0.9, -0.9, 0.0, 0.0])
    goal = np.array([0.9, 0.9, 0.0, 0.0])
    params = CHOMPParams(n_support_points=32, dt=0.04, opt_iters=100,
                         step_size=0.2, grad_clip=0.1, sigma_coll=1e-2,
                         weight_prior_cost=1e-4)
    theta0 = np.tile(straight_line_trajs(t(start), t(goal), 32).numpy(),
                     (4, 1, 1))
    jres, pres = run_both(*pm_tasks, theta0, start, goal, params)
    hold(jres, pres)
    assert tuple(pres.cost_trace.shape) == (100,)
    assert float(pres.cost_trace[-1]) < float(pres.cost_trace[0])
    np.testing.assert_allclose(pres.trajs[:, 0, :2].numpy(),
                               np.tile(start[:2], (4, 1)), atol=0.05)


def test_chomp_per_problem_trace_keeps_the_batch_axes(pm_tasks):
    """theta0 (2, 3, H, 4) with per-problem endpoints: the trace is (iters,
    2, 3) in both packages and sums to the batch-summed trace."""
    rng = np.random.default_rng(6)
    start = np.concatenate([rng.uniform(-0.95, -0.8, (2, 3, 2)),
                            np.zeros((2, 3, 2))], -1)
    goal = np.concatenate([rng.uniform(0.8, 0.95, (2, 3, 2)),
                           np.zeros((2, 3, 2))], -1)
    params = CHOMPParams(n_support_points=16, opt_iters=8, step_size=0.2,
                         grad_clip=0.1)
    theta0 = straight_line_trajs(t(start), t(goal), 16).numpy()
    jres, pres = run_both(*pm_tasks, theta0, start, goal, params,
                          per_problem=True)
    assert tuple(pres.cost_trace.shape) == (8, 2, 3)
    hold(jres, pres)
    summed = chomp_solve(pm_tasks[1].collision_residuals, t(theta0),
                         t(start), t(goal), params)
    np.testing.assert_allclose(summed.cost_trace.numpy(),
                               pres.cost_trace.sum(dim=(1, 2)).numpy(),
                               rtol=1e-12)


def test_chomp_panda_matches_jax_in_float64():
    """Panda in EnvSpheres3D (cutoff 0.03), 2 problems x 2 lanes, H = 8, 6
    iterations at CHOMPParams' defaults: the obstacle gradient through the
    lanes terms (K1's plain version) and the trace through the value-only
    cost (K8's)."""
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.03)
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.03)
    assert ptask.collision_residuals.collision_cost_lanes is not None
    lo, hi = ptask.robot.model.q_lower, ptask.robot.model.q_upper
    rng = np.random.default_rng(7)
    q0 = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=(2, 2, 7))
    q1 = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=(2, 2, 7))
    start = np.concatenate([q0, np.zeros_like(q0)], -1)
    goal = np.concatenate([q1, np.zeros_like(q1)], -1)
    params = CHOMPParams(n_support_points=8, opt_iters=6)
    theta0 = straight_line_trajs(t(start), t(goal), 8).numpy()
    jres, pres = run_both(jtask, ptask, theta0, start, goal, params)
    hold(jres, pres)
    assert np.isfinite(pres.trajs.numpy()).all()


def test_chomp_from_preset():
    """tests/test_solve_other.py:29's assertions, and the JAX package's
    fields from the same preset."""
    env = EnvDense2D(device="cpu")
    robot = RobotPointMass.create(device="cpu")
    preset = env.get_chomp_params(robot)
    params = CHOMPParams.from_preset(preset)
    assert params.n_support_points == 64
    assert params.step_size == pytest.approx(0.05)
    assert params.weight_prior_cost == pytest.approx(1e-4)
    assert params.__dict__ == JCHOMPParams.from_preset(preset).__dict__
    assert preset == JEnvDense2D().get_chomp_params(JRobotPointMass.create())


def _tanh_problem():
    theta0 = np.random.default_rng(11).uniform(-1.0, 1.0, (2, 8, 4))
    return theta0, theta0[:, 0], theta0[:, -1], CHOMPParams(
        n_support_points=8, opt_iters=5, sigma_coll=0.5, step_size=0.2)


def _tanh_parity(supports_batch):
    """tanh residuals without lanes terms: the port's autodiff branch
    against JAX's ``chomp_solve`` in float64 (trajectories and trace to
    1e-8)."""
    def residuals(q):
        return torch.tanh(q)
    residuals.supports_batch = supports_batch

    def jresiduals(q):
        return jnp.tanh(q)
    jresiduals.supports_batch = supports_batch
    theta0, start, goal, params = _tanh_problem()
    with jax.enable_x64(True):
        jres = jax_chomp_solve(jresiduals, jnp.asarray(theta0),
                               jnp.asarray(start), jnp.asarray(goal),
                               JCHOMPParams(**params.__dict__))
        jres = (np.asarray(jres.trajs), np.asarray(jres.cost_trace))
    hold(jres, chomp_solve(residuals, t(theta0), t(start), t(goal), params))


def test_chomp_without_lanes_terms_raises():
    """Residuals with no lanes terms take the autodiff branch (the
    reference's, JAX parity on tanh residuals); residuals that carry no
    gradient to the trajectory raise in the port's words, never a zero
    gradient."""
    _tanh_parity(True)

    def detached(q):
        return torch.tanh(q).detach()
    detached.supports_batch = True
    theta0, start, goal, params = _tanh_problem()
    with pytest.raises(RuntimeError, match="carry no gradient"):
        chomp_solve(detached, t(theta0), t(start), t(goal), params)


def test_chomp_autodiff_vmaps_per_sample_residuals():
    """Without ``supports_batch`` the residuals are vmapped, as the
    reference's are: the same float64 parity."""
    _tanh_parity(False)
