"""The learned self-collision Panda through the port's plain terms, cost
hook, collision check and MPC step, against the JAX package on the same
numpy inputs (the net carried across by ``convert.task_from_numpy``).

Three nets: the bundled checkpoint (its hinge relu(0.001 - sd) is almost
never active: it saturates near sd = 0.33, so on it a check sees a zero
row), and seeded relu and tanh nets of the bundled widths whose output
shift is set from the test's q so that 25-75% of the lanes are active,
which exercises the row's Jacobian.  Tolerance as tests/test_torch_terms.py:
atol 3e-5 * max|ref| plus rtol 2e-5.  Lanes whose reference sd lies within
1e-5 of the cutoff, where two correct float32 orders can flip the hinge,
are excluded and counted."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.ops.net_kernel import net_rows
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            mpc_step, straight_line_trajs)

from test_torch_kin import export_jax_task
from test_torch_self_collision_net import NPZ, jax_net, numpy_net, spread

N = 256
CUTOFF = 0.001            # PlanningTask._NET_SELF_CUTOFF in both packages
EDGE = 1e-5
KINDS = ("bundled", "relu_spread", "tanh_spread")


def _rand_q(n, seed):
    """q (7, n) over 1.4x the joint range: some joints past their clamps."""
    model = RobotPanda.create(device="cpu").model
    rng = np.random.default_rng(seed)
    lo, hi = model.q_lower, model.q_upper
    u = rng.uniform(-0.2, 1.2, size=(7, n))
    return (lo[:, None] + u * (hi - lo)[:, None]).astype(np.float32)


def net_task(kind, q_for_shift=None, cutoff=0.03):
    """(JAX task, port task) of the net Panda in EnvSpheres3D; a spread
    kind's shift is set from q_for_shift (d, n)."""
    jrobot = JRobotPanda.create(use_learned_self_collision=True)
    if kind != "bundled":
        with np.load(NPZ) as data:
            arrays = numpy_net([7, 256, 128, 64, 1], kind.split("_")[0],
                               seed=21, like=data)
        arrays = spread(arrays, q_for_shift.T)
        jrobot = dataclasses.replace(jrobot,
                                     self_collision_net=jax_net(arrays))
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=cutoff)
    return jtask, task_from_numpy(export_jax_task(jtask), device="cpu")


@pytest.fixture(scope="module", params=KINDS)
def tasks(request):
    q = _rand_q(N, seed=31)
    jtask, ptask = net_task(request.param, q)
    sd = np.asarray(jtask.robot.self_collision_net.signed_distance(
        jnp.asarray(q.T)))
    active = float(np.mean(sd < CUTOFF))
    if request.param != "bundled":
        assert 0.25 <= active <= 0.75, active
    keep = np.abs(sd - CUTOFF) >= EDGE
    assert int((~keep).sum()) <= 2
    return request.param, jtask, ptask, q, keep


def _hold(got, ref, keep_lanes):
    """got, ref with lanes last (any layout); keep_lanes broadcast to their
    lane axes."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    tol = 3e-5 * np.abs(ref).max() + 2e-5 * np.abs(ref)
    bad = (np.abs(got - ref) > tol) & keep_lanes
    assert not bad.any(), float(np.abs(got - ref)[keep_lanes].max())


@pytest.mark.parametrize("h", [None, 8])
def test_terms_match_jax(tasks, h):
    kind, jtask, ptask, q, keep = tasks
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 77.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(
        torch.as_tensor(q), 77.0, h=h)
    lanes = keep if h is None else keep.reshape(h, N // h)
    for r, g, extra in zip(ref, got, (1, 2, 0)):
        k = lanes.reshape(lanes.shape[:1] + (1,) * extra + lanes.shape[1:]) \
            if h is not None else lanes
        _hold(g.numpy(), r, k)


def test_unscaled_terms_match_jax(tasks):
    kind, jtask, ptask, q, keep = tasks
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 1.0)
    got = ptask.collision_residuals.obstacle_terms_lanes.unscaled(
        torch.as_tensor(q))
    _hold(got[0].numpy(), np.asarray(ref[0])[:7], keep)
    _hold(got[1].numpy(), np.asarray(ref[1])[:7, :7], keep)
    _hold(got[2].numpy(), ref[2], keep)


def test_rows_net_last_match_jax(tasks):
    """P = 2 x (object points) + 1, the net row last; the rows and their
    Jacobians equal JAX's residuals_and_jacobian and the plain row."""
    kind, jtask, ptask, q, keep = tasks
    qb = q.T.reshape(16, 16, 7)
    res = ptask.collision_residuals
    r, J = res.residuals_and_jacobian(torch.as_tensor(qb))
    jr, jJ = jtask.collision_residuals.residuals_and_jacobian(
        jnp.asarray(qb))
    n_obj = len(ptask.robot.object_coll_idxs)
    assert r.shape == jr.shape == (16, 16, 2 * n_obj + 1)
    assert J.shape == jJ.shape == (16, 16, 2 * n_obj + 1, 7)
    k = keep.reshape(16, 16)[..., None]
    _hold(r.numpy(), jr, k)
    _hold(J.numpy(), jJ, k[..., None])
    _hold(res(torch.as_tensor(qb)).numpy(),
          jtask.collision_residuals(jnp.asarray(qb)), k)
    rows_r, rows_J = res.obstacle_terms_lanes.plain.rows(torch.as_tensor(q))
    r_n, J_n = net_rows(ptask.robot.self_collision_net, torch.as_tensor(q),
                        CUTOFF)
    assert torch.equal(rows_r[-1], r_n) and torch.equal(rows_J[-1], J_n)
    if kind != "bundled":
        assert 0.25 <= float((r_n > 0).float().mean()) <= 0.75


def test_cost_hook_matches_jax(tasks):
    kind, jtask, ptask, q, keep = tasks
    got = ptask.collision_residuals.collision_cost_lanes(torch.as_tensor(q))
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 1.0)[2]
    _hold(got.numpy(), ref, keep)


@pytest.mark.parametrize("margin", [None, 0.0])
def test_compute_collision_matches_jax(tasks, margin):
    """The net's fixed -0.05 test replaces the pair check, margin or not;
    lanes within 1e-5 of that threshold are excluded."""
    kind, jtask, ptask, q, keep = tasks
    x = np.concatenate([q.T, np.zeros_like(q.T)], -1)
    got = ptask.compute_collision(torch.as_tensor(x), margin=margin).numpy()
    ref = np.asarray(jtask.compute_collision(jnp.asarray(x), margin=margin))
    sd = np.asarray(jtask.robot.self_collision_net.signed_distance(
        jnp.asarray(q.T)))
    edge = np.abs(sd + 0.05) < EDGE
    assert int(edge.sum()) <= 2 and 0 < int(got.sum()) < N
    np.testing.assert_array_equal(got[~edge], ref[~edge])
    if kind != "bundled":
        assert bool((got[sd < -0.06]).all())


def test_chained_mpc_step_with_spread_net_matches_jax_in_float64():
    """One MPC step (2 GN iterations) at B = 8, H = 16 with a relu spread
    net active on ~half the straight-line waypoints, both packages in
    float64, to 1e-8 of max|theta| (as tests/test_torch_mpc_float64.py
    holds the pair-field Panda)."""
    B, H = 8, 16
    gp = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
              sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
              step_size=1.0)
    model = RobotPanda.create(device="cpu").model
    rng = np.random.default_rng(0)
    lo, hi = model.q_lower.astype(np.float64), model.q_upper.astype(
        np.float64)
    q_start = lo + 0.25 * (hi - lo) * (1 + rng.uniform(size=(B, 7))) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + rng.uniform(size=(B, 7))) / 2
    start = np.concatenate([q_start, 0 * q_start], -1)
    goal = np.concatenate([q_goal, 0 * q_goal], -1)
    theta0 = straight_line_trajs(torch.as_tensor(start),
                                 torch.as_tensor(goal), H).numpy()
    waypoints = theta0[..., :7].reshape(-1, 7).T.astype(np.float32)
    with jax.enable_x64(True):
        jtask, ptask = net_task("relu_spread", waypoints)
        sd = np.asarray(jtask.robot.self_collision_net.signed_distance(
            jnp.asarray(waypoints.T, jnp.float64)))
        assert 0.25 <= float(np.mean(sd < CUTOFF)) <= 0.75
        j_state, _ = jax.jit(lambda st, g: jax_mpc_step(
            jtask.collision_residuals, st, g,
            JMPCParams(gpmp2=JGPMP2Params(**gp), iters_per_step=2)))(
                JMPCState(theta=jnp.asarray(theta0), x=jnp.asarray(start)),
                jnp.asarray(goal))
        j_theta = np.asarray(j_state.theta, np.float64)
    p_state, _ = mpc_step(
        ptask.collision_residuals,
        MPCState(theta=torch.as_tensor(theta0), x=torch.as_tensor(start)),
        torch.as_tensor(goal),
        MPCParams(gpmp2=GPMP2Params(**gp), iters_per_step=2))
    p_theta = p_state.theta.numpy()
    assert p_theta.shape == (B, H, 14) and np.isfinite(p_theta).all()
    # the step moved the plans: the net row pulled on them
    assert np.abs(p_theta - theta0).max() > 1e-3
    np.testing.assert_allclose(p_theta, j_theta,
                               atol=1e-8 * np.abs(j_theta).max())
