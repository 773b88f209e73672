"""GN obstacle terms and costs in precomputed-grid scenes (the plain
version of the CUDA kernels' grid branch) vs the JAX package's XLA lanes
path, on the same numpy inputs and the same grid (carried across by
convert.py): the Panda in a grid-only EnvSpheres3D (0.05 m cells), config
4's MultiRobot in the same grid, and the point mass in EnvDense2D's 2-D
grid (0.01 m); one GN step of the grid workload's GPMP2Params at B = 4,
H = 16; and the trajectories' independence of the batch.

Tolerances: the terms' (tests/test_pallas_terms.py): atol 3e-5 * max|ref|
plus rtol 2e-5, float32 sums in another order; the GN step 1e-3 of
max|theta| (tests/test_torch_mpc.py's bound).  Exclusion rule: a lane
whose object collision point lies within 1e-4 of a cell width of a cell
face (``GridSDF.near_face``, judged from the JAX package's points) may be
off the tolerance: there an ulp of float32 FK picks the neighbouring cell,
whose value differs by up to a cell width times |grad|.  Every other lane
is held, and at most 0.1% of the lanes may be off; the GN step's 64
waypoints are held without exception."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    fk_positions_lanes as jax_fk_positions_lanes
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as jax_mr_terms_factory
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.gpmp2 import gpmp2_step as jax_gpmp2_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.geom import GridSDF
from torch_robotics_tpu_torch.ops.lanes_fk import (
    _grid_sdf_lanes_multi, _grid_sdf_value_lanes_multi, lanes_supported_scene,
    sdf_and_grad_lanes, sdf_lanes)
from torch_robotics_tpu_torch.solve import (GPMP2Params, gpmp2_step,
                                            straight_line_trajs)

from test_torch_grid_sdf import grid_arrays
from test_torch_kin import export_jax_task
from test_torch_multi_robot import CONFIG4, export_jax_multirobot_task

CELL = 0.05
FACE_SHARE = 1e-3
B, H = 4, 16
# benchmarks/grid_sdf_bench.py's GPMP2Params at H = 16
GP = dict(n_support_points=H, dt=0.04, sigma_start=1e-3, sigma_gp=1e-1,
          sigma_goal_prior=1e-2, sigma_coll=5e-4, step_size=0.8)


def _grid_task(jtask_plain, jgrid, export=export_jax_task):
    """The port's task of a JAX task's robot in the scene [jgrid]."""
    arrays = export(jtask_plain)
    arrays["objects"] = [{"grid": grid_arrays(jgrid)}]
    return task_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def panda():
    jenv = JEnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=CELL)
    jrobot = JRobotPanda.create()
    jtask = JPlanningTask(env=jenv, robot=jrobot, obstacle_cutoff_margin=0.02)
    ptask = _grid_task(JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                                     obstacle_cutoff_margin=0.02),
                       jenv.grid_map_sdf_obj_fixed)
    return jtask, ptask


def _rand_q(lo, hi, n, seed):
    """q (d, n) over 1.4x the joint range: some joints past their clamps."""
    u = np.random.default_rng(seed).uniform(-0.2, 1.2, size=(lo.shape[0], n))
    return (lo[:, None] + u * (hi - lo)[:, None]).astype(np.float32)


def _lane_last(x, h):
    """A terms output in embed_terms' layout -> lanes last (..., N)."""
    x = np.asarray(x)
    if h is None:
        return x
    return np.moveaxis(x, 0, -2).reshape(x.shape[1:-1] + (-1,))


def _close(got, ref, grid, pts, h=None):
    """Every output of every lane within the tolerance, except lanes with
    a reference point near a cell face (pts (N, P, dim)), at most
    FACE_SHARE of them."""
    near = grid.near_face(torch.as_tensor(np.array(pts))).any(-1).numpy()
    off = np.zeros(near.shape, bool)
    for g, r in zip(got, ref):
        g, r = _lane_last(g.numpy(), h), _lane_last(r, h)
        assert g.shape == r.shape
        bad = np.abs(g - r) > 3e-5 * float(np.abs(r).max()) + 2e-5 * np.abs(r)
        off |= bad.reshape(-1, bad.shape[-1]).any(0)
    assert not (off & ~near).any()
    assert off.sum() <= FACE_SHARE * off.size


def _panda_points(jtask, q):
    """The JAX package's object collision points of q (d, N): (N, P, 3)."""
    pts = jax_fk_positions_lanes(jtask.robot.model, jnp.asarray(q.T))
    return np.asarray(pts)[:, list(jtask.robot.object_coll_idxs)]


@pytest.mark.parametrize("h", [None, 8])
def test_panda_grid_terms_match_jax(panda, h):
    jtask, ptask = panda
    model = ptask.robot.model
    q = _rand_q(model.q_lower, model.q_upper, 2048, seed=5)
    grid, pts = ptask.df_obj_list[0], _panda_points(jtask, q)
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 77.0, h=h)
    terms = ptask.collision_residuals.obstacle_terms_lanes
    _close(terms(torch.as_tensor(q), 77.0, h=h), ref, grid, pts, h)
    # the value-only cost: the unscaled terms' cost
    cost = ptask.collision_residuals.collision_cost_lanes(torch.as_tensor(q))
    _close([cost], [_lane_last(ref[2], h) / 77.0], grid, pts)


def test_grid_only_scene_keeps_its_object_rows(panda):
    """EnvSpheres3D has no extra objects: the grid is the whole scene, and
    its object rows are there (one per object point, before the workspace
    rows), active on some lanes."""
    _, ptask = panda
    assert len(ptask.df_obj_list) == 1
    assert isinstance(ptask.df_obj_list[0], GridSDF)
    assert lanes_supported_scene(ptask.df_obj_list)
    robot = ptask.robot
    q = torch.as_tensor(_rand_q(robot.model.q_lower, robot.model.q_upper,
                                512, seed=6))
    r, Jr = ptask.collision_residuals.obstacle_terms_lanes.plain.rows(q)
    n_obj, n_pair = len(robot.object_coll_idxs), len(robot.self_pair_idxs)
    assert r.shape == (2 * n_obj + n_pair, 512)
    assert bool((r[:n_obj] > 0).any()) and bool((Jr[:n_obj] != 0).any())


def test_scene_queries_match_jax(panda):
    """sdf_and_grad_lanes / sdf_lanes and the multi-point lookups on the
    grid scene against the JAX package's lanes functions."""
    from torch_robotics_tpu.ops import lanes_fk as jl
    jtask, ptask = panda
    grid, jgrid = ptask.df_obj_list[0], jtask.df_obj_list[0]
    x = np.random.default_rng(8).uniform(-1.1, 1.1, size=(4, 3, 300)).astype(
        np.float32)
    pts = torch.as_tensor(x)
    jpts = [tuple(jnp.asarray(p[k]) for k in range(3)) for p in x]
    v, g = sdf_and_grad_lanes(ptask.df_obj_list, pts[0])
    jv, jg = jl.sdf_and_grad_lanes(jtask.df_obj_list, jpts[0], 3)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(g.numpy(), np.stack(jg))
    np.testing.assert_array_equal(
        sdf_lanes(ptask.df_obj_list, pts[0]).numpy(),
        np.asarray(jl.sdf_lanes(jtask.df_obj_list, jpts[0])))
    vm, gm = _grid_sdf_lanes_multi(grid, pts)
    jvm, jgm = jl._grid_sdf_lanes_multi(jgrid, jpts)
    np.testing.assert_array_equal(vm.numpy(), np.asarray(jvm))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jgm))
    np.testing.assert_array_equal(
        _grid_sdf_value_lanes_multi(grid, pts).numpy(),
        np.asarray(jl._grid_sdf_value_lanes_multi(jgrid, jpts)))


def test_multirobot_grid_terms_match_jax():
    """Config 4's arms in the grid scene against the JAX package's
    structured MultiRobot terms (obstacle_terms_lanes_multirobot_factory):
    the plain version of the CUDA MultiRobot terms kernel, and the
    MultiRobot cost."""
    jenv = JEnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=CELL)
    make = {"panda": JRobotPanda.create, "ur10": JRobotUR10}
    robot = JMultiRobot.create(
        [make[k]() for k, _, _ in CONFIG4],
        [(jz_rot(jnp.array(yaw, jnp.float32)),
          jnp.array([x, y, 0.0], jnp.float32)) for _, (x, y), yaw in CONFIG4])
    jtask = JPlanningTask(env=jenv, robot=robot, obstacle_cutoff_margin=0.02)
    ptask = _grid_task(JPlanningTask(env=JEnvSpheres3D(), robot=robot,
                                     obstacle_cutoff_margin=0.02),
                       jenv.grid_map_sdf_obj_fixed,
                       export_jax_multirobot_task)
    lo, hi = ptask.robot.q_min.numpy(), ptask.robot.q_max.numpy()
    q = _rand_q(lo, hi, 1024, seed=9)
    n_obj = sum(ptask.robot.obj_counts)
    jpts = np.asarray(robot.fk_map_collision(jnp.asarray(q.T)))[:, :n_obj]
    grid = ptask.df_obj_list[0]
    ref = jax_mr_terms_factory(jtask)(jnp.asarray(q), 50.0)
    res = ptask.collision_residuals
    _close(res.obstacle_terms_lanes(torch.as_tensor(q), 50.0), ref, grid,
           jpts)
    _close([res.collision_cost_lanes(torch.as_tensor(q))],
           [np.asarray(ref[2]) / 50.0], grid, jpts)
    r = res.obstacle_terms_lanes.plain.rows(torch.as_tensor(q))[0]
    assert bool((r[:n_obj] > 0).any())


def test_point_mass_2d_grid_terms_match_jax():
    """The point mass in EnvDense2D's 2-D grid (JAX's
    tests/test_lanes_terms.py scene): plain terms on every device, in
    both packages."""
    jenv = JEnvDense2D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.01)
    jrobot = JRobotPointMass.create()
    jtask = JPlanningTask(env=jenv, robot=jrobot, obstacle_cutoff_margin=0.01)
    arrays = dict(robot="point_mass",
                  q_limits=np.stack([np.asarray(jrobot.q_min),
                                     np.asarray(jrobot.q_max)]),
                  object_margins=np.asarray(jrobot.object_margins),
                  dt=np.float64(1.0), ws_limits=np.asarray(jtask.ws_limits),
                  obstacle_cutoff_margin=np.float64(0.01),
                  objects=[{"grid": grid_arrays(jenv.grid_map_sdf_obj_fixed)}])
    ptask = task_from_numpy(arrays, device="cpu")
    q = np.random.default_rng(10).uniform(-1.05, 1.05, size=(2, 4096)).astype(
        np.float32)
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 3.0)
    got = ptask.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                         3.0)
    _close(got, ref, ptask.df_obj_list[0], q.T[:, None])
    assert float(np.abs(np.asarray(ref[0])).max()) > 0


def _start_goal(n):
    """bench.py's start/goal draw (numpy seed 0, the first n of 1024)."""
    from torch_robotics_tpu_torch.robots import RobotPanda
    model = RobotPanda.create(device="cpu").model
    rng = np.random.default_rng(0)
    lo, hi = model.q_lower.astype(np.float64), model.q_upper.astype(
        np.float64)
    u1, u2 = rng.uniform(size=(1024, 7))[:n], rng.uniform(size=(1024, 7))[:n]
    q_start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    return (np.concatenate([q_start, 0 * q_start], -1).astype(np.float32),
            np.concatenate([q_goal, 0 * q_goal], -1).astype(np.float32))


def test_gpmp2_step_in_grid_scene_matches_jax(panda):
    jtask, ptask = panda
    start, goal = _start_goal(B)
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
                               atol=1e-3 * np.abs(j_theta).max())
    np.testing.assert_allclose(p_cost.numpy(), np.asarray(j_cost), rtol=1e-3)
    assert float(p_cost.max()) > 0            # the grid rows take part


def test_trajectories_do_not_depend_on_the_batch(panda):
    """A GN step's trajectories are independent systems: the first 4 of a
    B = 8 step equal a B = 4 step from the same start (the float64 hold of
    chip_smoke.py's grid_main takes the first lanes of a larger batch).
    Held in float64 to 1e-9 of max|theta|: in float32 the batched CPU
    products and factorizations round by batch size, and the step's
    conditioning (lam = 4e6) lifts that to ~1e-3."""
    _, ptask = panda
    start, goal = (torch.as_tensor(a, dtype=torch.float64)
                   for a in _start_goal(8))
    gp = GPMP2Params(**GP)
    out = []
    for n in (8, 4):
        th = straight_line_trajs(start[:n], goal[:n], H)
        out.append(gpmp2_step(ptask.collision_residuals, th, start[:n],
                              goal[:n], gp))
    scale = float(out[1][0].abs().max())
    torch.testing.assert_close(out[0][0][:4], out[1][0], rtol=0,
                               atol=1e-9 * scale)
    torch.testing.assert_close(out[0][1][:4], out[1][1], rtol=1e-9, atol=0)
