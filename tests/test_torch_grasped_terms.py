"""The grasped-object Panda's GN obstacle terms and cost (the plain version
of the grasped branch of the CUDA terms and cost kernels) and its GN and
MPC steps vs the JAX package, on the same numpy inputs: the Panda holding
GraspedObjectPandaBox in EnvSpheres3D at the grasped-terms workload's
cutoff 0.03 (benchmarks/pallas_terms_ab.py), the three-arm MultiRobot
with a grasped member (tests/test_multi_robot.py:108-135), and the
grasped Panda in a grid-only EnvSpheres3D (0.05 m cells).

The JAX side is its XLA lanes terms (``obstacle_terms_lanes_factory``),
which benchmarks/pallas_terms_ab.py holds its Pallas kernel to; that
kernel takes ~650 s to compile in interpret mode for the grasped robot
(tests/test_pallas_terms.py:25-27), so it is not run here.

Tolerances: terms and cost as tests/test_pallas_terms.py holds the kernel
(atol 3e-5 * max|ref| plus rtol 2e-5, float32 sums in another order); the
grid scene by tests/test_torch_grid_terms.py's rule (a lane off it only
where a point lies within 1e-4 cell widths of a cell face, at most 0.1%
of the lanes); one GN step 1e-3 of max|theta| (tests/test_torch_mpc.py);
the chained MPC step in float64 1e-7 of max|theta|
(tests/test_torch_mpc_float64.py: the two packages agree to ~1e-10
there, while float32 runs of this ill-conditioned step differ by up to
~0.25)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grasped import (export_grasped, jax_grasped_multirobot_task,
                                jax_grasped_task)
from test_torch_grid_sdf import grid_arrays
from test_torch_grid_terms import _close as grid_close
from test_torch_multi_robot import export_jax_multirobot_task
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as jax_mr_terms_factory
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.gpmp2 import gpmp2_step as jax_gpmp2_step
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            gpmp2_step, mpc_step,
                                            straight_line_trajs)

ATOL_REL, RTOL = 3e-5, 2e-5
N_TERMS = 8 * 40
# bench.py's GPMP2Params at a short horizon
B, H = 4, 16
GP = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
          sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
          step_size=1.0)
TOL, TOL_F64 = 1e-3, 1e-7
B64, H64 = 8, 32
CELL = 0.05


def _rand_q(lo, hi, n, seed):
    """q (d, n) over 1.4x the joint range: some joints past their clamps."""
    u = np.random.default_rng(seed).uniform(-0.2, 1.2, size=(lo.shape[0], n))
    return (lo[:, None] + u * (hi - lo)[:, None]).astype(np.float32)


def _close(got, ref, name=""):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        assert float(np.abs(r).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=ATOL_REL * float(np.abs(r).max()),
                                   rtol=RTOL, err_msg=name)


@pytest.fixture(scope="module")
def grasped():
    jtask = jax_grasped_task()
    return jtask, task_from_numpy(export_grasped(jtask), device="cpu")


@pytest.fixture(scope="module")
def q_terms(grasped):
    m = grasped[1].robot.model
    return _rand_q(m.q_lower, m.q_upper, N_TERMS, seed=5)


@pytest.mark.parametrize("h", [None, 8])
def test_terms_match_jax(grasped, q_terms, h):
    jtask, ptask = grasped
    ref = jax_terms_factory(jtask)(jnp.asarray(q_terms), 77.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(
        torch.as_tensor(q_terms), 77.0, h=h)
    _close(got, ref, "h=%s" % h)


def test_cost_hook_matches_jax(grasped, q_terms):
    """The value-only cost hook (the plain version of K8's grasped branch):
    the unscaled cost of JAX's lanes terms."""
    jtask, ptask = grasped
    ref = np.asarray(jax_terms_factory(jtask)(jnp.asarray(q_terms), 1.0)[2])
    got = ptask.collision_residuals.collision_cost_lanes(
        torch.as_tensor(q_terms))
    _close([got], [ref])


def test_rows_cover_the_grasped_points(grasped, q_terms):
    """104 rows (19 SDF, 19 workspace, 66 pairs); rows of grasped points
    are active on some lanes, and zero off their live columns; the rows
    reassemble into the terms."""
    _, ptask = grasped
    terms = ptask.collision_residuals.obstacle_terms_lanes
    q = torch.as_tensor(q_terms)
    r, Jr = terms.plain.rows(q)
    assert r.shape == (104, N_TERMS) and Jr.shape == (104, 7, N_TERMS)
    lay = TermsLayout(ptask)
    assert lay.point_links == lay.used_links + [11] * 14
    grasped_rows = np.r_[5:19, 24:38, 48:104]
    assert bool((r[grasped_rows] > 0).any())
    a, b = lay.row_joints()
    assert (a | b).shape == (104, 7)
    assert bool((Jr[torch.as_tensor(~(a | b))] == 0).all())
    g, Hqq, cost = terms.plain.unscaled(q)
    torch.testing.assert_close(cost, 0.5 * torch.sum(r * r, dim=0))
    torch.testing.assert_close(g, torch.sum(r[:, None] * Jr, dim=0))


def _start_goal(robot, n):
    """bench.py's start/goal draw (numpy seed 0, the first n of 1024)."""
    lo = robot.model.q_lower.astype(np.float64)
    hi = robot.model.q_upper.astype(np.float64)
    rng = np.random.default_rng(0)
    u1 = rng.uniform(size=(1024, 7))[:n]
    u2 = rng.uniform(size=(1024, 7))[:n]
    q_start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    return (np.concatenate([q_start, 0 * q_start], -1).astype(np.float32),
            np.concatenate([q_goal, 0 * q_goal], -1).astype(np.float32))


def test_gpmp2_step_matches_jax(grasped):
    jtask, ptask = grasped
    start, goal = _start_goal(ptask.robot, B)
    s_t, g_t = torch.as_tensor(start), torch.as_tensor(goal)
    theta0 = straight_line_trajs(s_t, g_t, H)
    j_theta, j_cost = jax.jit(lambda th, s, g: jax_gpmp2_step(
        jtask.collision_residuals, th, s, g, JGPMP2Params(**GP)))(
            jnp.asarray(theta0.numpy()), jnp.asarray(start),
            jnp.asarray(goal))
    p_theta, p_cost = gpmp2_step(ptask.collision_residuals, theta0, s_t, g_t,
                                 GPMP2Params(**GP))
    j_theta = np.asarray(j_theta)
    assert np.isfinite(p_theta.numpy()).all()
    np.testing.assert_allclose(p_theta.numpy(), j_theta,
                               atol=TOL * np.abs(j_theta).max())
    np.testing.assert_allclose(p_cost.numpy(), np.asarray(j_cost), rtol=TOL)
    assert float(p_cost.max()) > 0


def test_chained_mpc_step_matches_jax_in_float64():
    """One MPC step (2 chained GN iterations) of the grasped Panda in
    float64 in both packages (B = 8, H = 32)."""
    with jax.enable_x64(True):
        jtask = jax_grasped_task()
        ptask = task_from_numpy(export_grasped(jtask), device="cpu")
        start, goal = _start_goal(ptask.robot, B64)
        gp = dict(GP, n_support_points=H64)
        theta0 = straight_line_trajs(torch.as_tensor(start),
                                     torch.as_tensor(goal), H64).double()
        j_state, _ = jax.jit(lambda st, g: jax_mpc_step(
            jtask.collision_residuals, st, g,
            JMPCParams(gpmp2=JGPMP2Params(**gp), iters_per_step=2)))(
                JMPCState(theta=jnp.asarray(theta0.numpy()),
                          x=jnp.asarray(start, jnp.float64)),
                jnp.asarray(goal, jnp.float64))
        j_theta = np.asarray(j_state.theta, np.float64)
    p_state, info = mpc_step(
        ptask.collision_residuals,
        MPCState(theta=theta0, x=torch.as_tensor(start).double()),
        torch.as_tensor(goal).double(),
        MPCParams(gpmp2=GPMP2Params(**gp), iters_per_step=2))
    p_theta = p_state.theta.numpy()
    assert p_theta.dtype == np.float64 and np.isfinite(p_theta).all()
    assert float(info["collision_cost"].max()) > 0
    np.testing.assert_allclose(p_theta, j_theta,
                               atol=TOL_F64 * np.abs(j_theta).max())


def test_multirobot_terms_match_jax():
    """The three-arm MultiRobot with a grasped member: the port's
    block-structured terms (the plain version of K5's grasped branch) and
    its cost against JAX's structured MultiRobot terms; mutual rows of the
    grasped points are active on some lanes."""
    jtask = jax_grasped_multirobot_task()
    ptask = task_from_numpy(export_grasped(jtask, export_jax_multirobot_task),
                            device="cpu")
    lo, hi = ptask.robot.q_min.numpy(), ptask.robot.q_max.numpy()
    q = _rand_q(lo, hi, 96, seed=6)
    ref = jax_mr_terms_factory(jtask)(jnp.asarray(q), 1.0)
    res = ptask.collision_residuals
    _close(res.obstacle_terms_lanes(torch.as_tensor(q), 1.0), ref)
    _close([res.collision_cost_lanes(torch.as_tensor(q))], [ref[2]])
    lay = res.obstacle_terms_lanes.plain.layout
    grasped_first = [a for (i, j), rows in lay.groups.items() if i == 0
                     for a, _, _ in rows]
    assert 18 in grasped_first                  # the last grasped point
    r = res.obstacle_terms_lanes.plain.rows(torch.as_tensor(q))[0]
    n_mut = sum(len(v) for v in lay.groups.values())
    assert r.shape[0] == 2 * 30 + len(ptask.robot.self_pair_idxs)
    assert bool((r[-n_mut:] > 0).any())


def test_grid_terms_match_jax():
    """The grasped Panda in a grid-only EnvSpheres3D: the grasped points
    take the grid's cells too."""
    jenv = JEnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=CELL)
    jtask = jax_grasped_task(cutoff=0.02, env=jenv)
    arrays = export_grasped(jax_grasped_task(cutoff=0.02))
    arrays["objects"] = [{"grid": grid_arrays(jenv.grid_map_sdf_obj_fixed)}]
    ptask = task_from_numpy(arrays, device="cpu")
    m = ptask.robot.model
    q = _rand_q(m.q_lower, m.q_upper, 1024, seed=7)
    pts = np.asarray(jtask.robot.object_collision_points(
        jtask.robot.fk_map_collision(jnp.asarray(q.T))))
    assert pts.shape == (1024, 19, 3)
    grid = ptask.df_obj_list[0]
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 77.0)
    res = ptask.collision_residuals
    grid_close(res.obstacle_terms_lanes(torch.as_tensor(q), 77.0), ref, grid,
               pts)
    grid_close([res.collision_cost_lanes(torch.as_tensor(q))],
               [np.asarray(ref[2]) / 77.0], grid, pts)
    r = res.obstacle_terms_lanes.plain.rows(torch.as_tensor(q))[0]
    assert bool((r[5:19] > 0).any())             # grasped points' grid rows
