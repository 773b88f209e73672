"""The port's GPMP2 step and MPC steps vs the JAX package, at a small size
of the main path (Panda in EnvSpheres3D, the bench's GPMP2Params,
B = 4, H = 16), on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.gp_prior import \
    gp_prior_terms as jax_gp_prior_terms
from torch_robotics_tpu.solve.gp_prior import \
    straight_line_trajs as jax_straight_line_trajs
from torch_robotics_tpu.solve.gpmp2 import gpmp2_step as jax_gpmp2_step
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            gp_prior_terms, gpmp2_step,
                                            mpc_init, mpc_step,
                                            straight_line_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask

B, H = 4, 16
# bench.py's GPMP2Params at H = 16
GP = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
          sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
          step_size=1.0)
# lam = 1/sigma_coll^2 = 1e8 makes the GN systems ill-conditioned: two
# correct float32 solves differ at ~1e-5..1e-4 of max|theta| from op order
# alone (and two chained iterations amplify that), so a tighter bound would
# test the op order, not the algorithm.  1e-3 is the bound the reference
# holds itself to against its source.
TOL = 1e-3


@pytest.fixture(scope="module")
def problem():
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.03)
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.03)
    # start/goal drawn as bench.py draws them, from a numpy seed
    rng = np.random.default_rng(0)
    lo = ptask.robot.model.q_lower.astype(np.float64)
    hi = ptask.robot.model.q_upper.astype(np.float64)
    u1, u2 = rng.uniform(size=(B, 7)), rng.uniform(size=(B, 7))
    q_start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    start = np.concatenate([q_start, 0 * q_start], -1).astype(np.float32)
    goal = np.concatenate([q_goal, 0 * q_goal], -1).astype(np.float32)
    return jtask, ptask, start, goal


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


def test_gp_prior_terms_match_jax(problem):
    _, _, start, goal = problem
    rng = np.random.default_rng(1)
    theta = rng.normal(size=(B, H, 14)).astype(np.float32)
    ref = jax_gp_prior_terms(jnp.asarray(theta), jnp.asarray(start),
                             jnp.asarray(goal), 0.04, 1e-3, 1e-1, 1e-3)
    got = gp_prior_terms(torch.as_tensor(theta), torch.as_tensor(start),
                         torch.as_tensor(goal), 0.04, 1e-3, 1e-1, 1e-3)
    # float32 products summed in another order: 1e-5 of max
    for g, r in zip(got, ref):
        _close(g, r, tol=1e-5)
    _close(straight_line_trajs(torch.as_tensor(start), torch.as_tensor(goal),
                               H),
           jax_straight_line_trajs(jnp.asarray(start), jnp.asarray(goal), H),
           tol=1e-6)      # linspace weights round differently (1 ulp)


def test_gpmp2_step_then_two_mpc_steps_match_jax(problem):
    jtask, ptask, start, goal = problem
    jgp, gp = JGPMP2Params(**GP), GPMP2Params(**GP)
    s_t, g_t = torch.as_tensor(start), torch.as_tensor(goal)
    theta0 = mpc_init(s_t, g_t, MPCParams(gpmp2=gp)).theta

    j_step = jax.jit(lambda th, s, g: jax_gpmp2_step(
        jtask.collision_residuals, th, s, g, jgp))
    j_theta, j_cost = j_step(jnp.asarray(theta0.numpy()), jnp.asarray(start),
                             jnp.asarray(goal))
    p_theta, p_cost = gpmp2_step(ptask.collision_residuals, theta0, s_t, g_t,
                                 gp)
    _close(p_theta, j_theta)
    np.testing.assert_allclose(p_cost.numpy(), np.asarray(j_cost), rtol=TOL)

    # two warm-started MPC steps from the step-1 plan
    j_mpc = jax.jit(lambda st, g: jax_mpc_step(
        jtask.collision_residuals, st, g,
        JMPCParams(gpmp2=jgp, iters_per_step=2)))
    j_state = JMPCState(theta=j_theta, x=jnp.asarray(start))
    p_state = MPCState(theta=p_theta, x=s_t)
    for _ in range(2):
        j_state, j_info = j_mpc(j_state, jnp.asarray(goal))
        p_state, p_info = mpc_step(ptask.collision_residuals, p_state, g_t,
                                   MPCParams(gpmp2=gp, iters_per_step=2))
        _close(p_state.theta, j_state.theta)
        _close(p_state.x, j_state.x)
        np.testing.assert_allclose(p_info["collision_cost"].numpy(),
                                   np.asarray(j_info["collision_cost"]),
                                   rtol=TOL)
        np.testing.assert_allclose(p_info["dist_to_goal"].numpy(),
                                   np.asarray(j_info["dist_to_goal"]),
                                   rtol=TOL)
