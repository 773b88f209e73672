"""A kinematic robot in a 2-D scene (the reference's fused factories with
ws_dim = 2, ROADMAP Queue 2 d): the port's plain terms and cost of the UR10
and the Panda in EnvDense2D (sixteen circles, fourteen rounded boxes)
against the JAX package's Pallas factories in interpret mode, the only
reference there is (the JAX package's XLA lanes terms fail on this input:
a broadcast of (3, P, N) points against its (2,) workspace bounds); the
kernels' CPU models (``model_terms``, ``model_cost``) on the 2-D packed
buffers against the plain version; what the packing writes for a 2-D
scene and what it refuses; the hooks of a Panda and of two Pandas taking
the 2-D task; and a pair with no mutual rows, whose MultiRobot terms are
its members' single-robot terms, in float64.

Tolerance: the terms test's (tests/test_pallas_terms.py): atol 3e-5 *
max|ref| plus rtol 2e-5, float32 sums in another order.  The MultiRobot
factory's interpret run (~2 min of CPU) is marked slow."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.ops.pallas_terms import (
    collision_cost_pallas_factory, obstacle_terms_pallas_factory)
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvBase, EnvDense2D
from torch_robotics_tpu_torch.geom import MultiSharpBoxField, ObjectField
from torch_robotics_tpu_torch.ops.terms_kernel import (
    _pack_scene, _scene_refusal, pack_cost_kernel_params,
    pack_multirobot_params, pack_terms_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask

from test_torch_cost_schedule import model_cost
from test_torch_grasped_launch import model_terms
from test_torch_kin import export_jax_task
from test_torch_multi_robot import (CONFIG4, export_jax_multirobot_task,
                                   model_mr_terms)

N, LAM, CUTOFF = 16, 77.0, 0.03
ATOL_REL, RTOL = 3e-5, 2e-5
ROBOTS = {"ur10": JRobotUR10, "panda": JRobotPanda.create}


def rand_q(lo, hi, n, seed):
    """q (d, n) float32 over 1.4x the joint range: some joints past their
    clamps."""
    u = np.random.default_rng(seed).uniform(-0.2, 1.2, size=(lo.shape[0], n))
    return (lo[:, None] + u * (hi - lo)[:, None]).astype(np.float32)


def hold(got, ref, name=""):
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        g = g.detach().double().numpy() if torch.is_tensor(g) else g
        assert float(np.abs(r).max()) > 0, name
        np.testing.assert_allclose(g, r, atol=ATOL_REL * np.abs(r).max(),
                                   rtol=RTOL, err_msg=name)


@pytest.fixture(scope="module", params=sorted(ROBOTS))
def case(request):
    """(name, the port's task, q, JAX's K1 terms (g, Hb, cost) at LAM and
    its K8 cost, each run once in interpret mode)."""
    robot = ROBOTS[request.param]()
    jtask = JPlanningTask(env=JEnvDense2D(), robot=robot,
                          obstacle_cutoff_margin=CUTOFF)
    q = rand_q(np.asarray(robot.q_min), np.asarray(robot.q_max), N, seed=3)
    terms = obstacle_terms_pallas_factory(jtask)(jnp.asarray(q), LAM,
                                                 interpret=True)
    cost = collision_cost_pallas_factory(jtask)(jnp.asarray(q),
                                                interpret=True)
    task = task_from_numpy(export_jax_task(jtask), device="cpu")
    return (request.param, task, q, [np.asarray(t) for t in terms],
            np.asarray(cost))


def test_plain_terms_match_jax_kernel_in_interpret_mode(case):
    name, task, q, ref, _ = case
    assert [r.shape for r in ref] == [(task.robot.q_dim * 2, N),
                                      (task.robot.q_dim * 2,) * 2 + (N,),
                                      (N,)]
    hold(task.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                       LAM), ref, name)


def test_plain_cost_matches_jax_cost_kernel_in_interpret_mode(case):
    name, task, q, _, ref = case
    hold([task.collision_residuals.collision_cost_lanes(torch.as_tensor(q))],
         [ref], name)


def test_kernel_models_on_the_2d_buffers_match_plain(case):
    """terms.cu's float64 model and cost.cu's float32 model, run on the 2-D
    task's packed buffers, give its plain terms and cost."""
    name, task, _, _, _ = case
    m = task.robot.model
    q = rand_q(m.q_lower, m.q_upper, 256, seed=4)
    plain = task.collision_residuals.obstacle_terms_lanes.plain
    ref = plain.unscaled(torch.as_tensor(q))
    lay = plain.layout
    hold(model_terms(*pack_terms_params(lay), q), ref, name + " terms")
    hold([model_cost(*pack_cost_kernel_params(lay), q)], [ref[2]],
         name + " cost")


def _sharp_2d(pos, ori):
    return ObjectField.create(
        [MultiSharpBoxField([[0.3, 0.1], [-0.35, 0.2]],
                            [[0.2, 0.3], [0.15, 0.4]], device="cpu")],
        pos=pos, ori=ori, device="cpu")


def test_2d_scene_packs_as_a_z_free_3d_scene():
    """A 2-D object packs its rotation with the third row and column zeroed,
    its primitives at z = 0 with an unbounded z half-size; the workspace's
    z bounds are -inf and +inf; a 2-D grid gets a third axis of one cell."""
    c, s = np.cos(0.15), np.sin(0.15)
    obj = _sharp_2d([0.05, -0.1, 0.1], [c, 0.0, 0.0, s])
    (_, kinds, counts, offs, obj_grid, _), (rot, pos, _, prims) = \
        _pack_scene([obj], 2)
    R = obj.rotation_matrix().numpy()
    want = np.zeros((3, 3), np.float32)
    want[:2, :2] = R[:2, :2]
    np.testing.assert_array_equal(rot[0].reshape(3, 3), want)
    np.testing.assert_array_equal(pos[0], obj.pos.numpy())
    assert kinds == [2] and counts == [2] and obj_grid == [-1]
    np.testing.assert_array_equal(
        prims.reshape(2, 6), np.float32([[0.3, 0.1, 0, 0.1, 0.15, np.inf],
                                         [-0.35, 0.2, 0, 0.075, 0.2,
                                          np.inf]]))
    env = EnvDense2D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.1,
                     device="cpu")
    grid = env.grid_map_sdf_obj_fixed
    (_, _, _, _, obj_grid, grid_i), (_, _, grid_f, _) = _pack_scene(
        env.get_df_obj_list(), 2)
    assert obj_grid == [0] and grid_i == [[0] + list(grid.cmap_dim) + [1]]
    lim = grid.limits.numpy()
    np.testing.assert_array_equal(grid_f[0], np.concatenate(
        [lim[0], [0, 0], np.abs(lim[1] - lim[0]), [1, 0]]).astype(np.float32))
    task = PlanningTask(env=env, robot=RobotPanda.create(device="cpu"))
    _, floats = pack_terms_params(
        task.collision_residuals.obstacle_terms_lanes.plain.layout)
    np.testing.assert_array_equal(floats[-6:], [-1, -1, -np.inf, 1, 1, np.inf])


def test_scenes_the_kernels_refuse():
    """Mixed dimensions, a scene of another dimension than the workspace,
    and a 2-D object posed off its plane are refused in words; a 2-D
    object turned about z at any height is taken."""
    c, s = np.cos(0.15), np.sin(0.15)
    flat = _sharp_2d([0.05, -0.1, 0.1], [c, 0.0, 0.0, s])
    assert _scene_refusal([flat], 2) is None
    tilted = _sharp_2d([0.05, -0.1, 0.1], [c, s, 0.0, 0.0])
    assert "plane" in _scene_refusal([tilted], 2)
    assert _scene_refusal([_sharp_2d([0, 0, 0], [c, s, 0, 0])], 2) is None
    ball = ObjectField.create(
        [MultiSharpBoxField([[0.3, 0.1, 0.2]], [[0.2, 0.3, 0.1]],
                            device="cpu")], device="cpu")
    assert "2-D/3-D objects" in _scene_refusal([flat, ball], 2)
    assert "in a 3-D workspace" in _scene_refusal([flat], 3)
    env = EnvBase(limits=[[-1, -1], [1, 1]], obj_fixed_list=[tilted],
                  device="cpu")
    res = PlanningTask(env=env, robot=RobotPanda.create(device="cpu"),
                       obstacle_cutoff_margin=CUTOFF).collision_residuals
    q = torch.zeros((7, 3))
    assert res.obstacle_terms_lanes.unscaled(q)[0].shape == (7, 3)
    meta = torch.zeros((7, 3), device="meta")
    for hook in (res.obstacle_terms_lanes.unscaled, res.collision_cost_lanes):
        with pytest.raises(NotImplementedError, match="plane"):
            hook(meta)


def _pair(mutual=True, env=None):
    """Two Pandas at config 4's poses (or both at the origin without mutual
    rows) in EnvDense2D."""
    poses = ([(z_rot(torch.tensor(yaw, dtype=torch.float32)),
               torch.tensor([x, y, 0.0]))
              for _, (x, y), yaw in CONFIG4[:2]] if mutual
             else [(torch.eye(3), torch.zeros(3))] * 2)
    robot = MultiRobot.create([RobotPanda.create(device="cpu")
                               for _ in range(2)], poses,
                              mutual_collision=mutual)
    return PlanningTask(env=env or EnvDense2D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=CUTOFF)


@pytest.mark.parametrize("grid", [False, True])
def test_hooks_take_the_2d_tasks(grid):
    """A Panda and two Pandas in EnvDense2D (analytic, and its grid) get
    packed K1 / K5 and K8 hooks with no refusal: a tensor off the CPU
    reaches the launch (whose check asks for a CUDA tensor) instead of a
    refusal."""
    env = EnvDense2D(precompute_sdf_obj_fixed=grid, sdf_cell_size=0.05,
                     device="cpu")
    for task in (PlanningTask(env=env, robot=RobotPanda.create(device="cpu"),
                              obstacle_cutoff_margin=CUTOFF),
                 _pair(env=env)):
        res = task.collision_residuals
        terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
        assert terms.refusal is None and cost.refusal is None
        assert terms.params[1] is not None and cost.params[1] is not None
        assert (terms.grid is not None) == grid
        meta = torch.zeros((task.robot.q_dim, 3), device="meta")
        for hook in (terms.unscaled, cost):
            with pytest.raises(ValueError, match="CUDA tensors"):
                hook(meta)


def test_multirobot_models_on_the_2d_buffers_match_plain():
    """mr_terms.cu's float64 model and cost.cu's float32 model, on config
    4's two Pandas' packed buffers in EnvDense2D, give their plain terms
    and cost."""
    task = _pair()
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    q = rand_q(task.robot.q_min.numpy(), task.robot.q_max.numpy(), 128,
               seed=10)
    ref = task.collision_residuals.obstacle_terms_lanes.plain.unscaled(
        torch.as_tensor(q))
    hold(model_mr_terms(*pack_multirobot_params(lay), q), ref, "mr terms")
    hold([model_cost(*pack_cost_kernel_params(lay), q)], [ref[2]],
         "mr cost")


@pytest.mark.parametrize("grid", [False, True])
def test_pair_without_mutual_rows_is_its_members_terms(grid):
    """Two Pandas at the origin with no mutual rows: the MultiRobot's 2-D
    terms are each member's single-robot 2-D terms on its columns (g, the
    diagonal blocks of Hqq, the summed cost; zero cross blocks), in
    float64.  The single robot's thresholds are margin + cutoff rounded to
    float32 (its layout's, as the reference's), the MultiRobot's summed in
    q's dtype (as the reference's structured terms): r differs by < 1e-8,
    so the two are held to 1e-6 of max|x|."""
    env = EnvDense2D(precompute_sdf_obj_fixed=grid, sdf_cell_size=0.05,
                     device="cpu")
    pair = _pair(mutual=False, env=env)
    single = PlanningTask(env=env, robot=RobotPanda.create(device="cpu"),
                          obstacle_cutoff_margin=CUTOFF)
    m = single.robot.model
    q = torch.as_tensor(np.concatenate(
        [rand_q(m.q_lower, m.q_upper, 64, seed=s) for s in (5, 6)]),
        dtype=torch.float64)
    g, Hqq, cost = pair.collision_residuals.obstacle_terms_lanes.plain \
        .unscaled(q)
    one = single.collision_residuals.obstacle_terms_lanes.plain.unscaled
    parts = [one(q[:7]), one(q[7:])]
    assert g.dtype == torch.float64 and float(cost.abs().max()) > 0

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    for i, (gi, Hi, _) in enumerate(parts):
        sl = slice(7 * i, 7 * i + 7)
        close(g[sl], gi)
        close(Hqq[sl, sl], Hi)
    assert float(Hqq[:7, 7:].abs().max()) == 0.0
    close(cost, parts[0][2] + parts[1][2])


@pytest.mark.slow
def test_multirobot_plain_terms_match_jax_kernel_in_interpret_mode():
    """Config 4's two Pandas in EnvDense2D: the port's plain MultiRobot
    terms and cost against the JAX package's fused MultiRobot factories in
    interpret mode (~2 min of CPU)."""
    robot = JMultiRobot.create(
        [JRobotPanda.create() for _ in range(2)],
        [(jz_rot(jnp.array(yaw, jnp.float32)),
          jnp.array([x, y, 0.0], jnp.float32))
         for _, (x, y), yaw in CONFIG4[:2]])
    jtask = JPlanningTask(env=JEnvDense2D(), robot=robot,
                          obstacle_cutoff_margin=CUTOFF)
    q = rand_q(np.asarray(robot.q_min), np.asarray(robot.q_max), N, seed=7)
    ref = obstacle_terms_pallas_factory(jtask)(jnp.asarray(q), LAM,
                                               interpret=True)
    ref_cost = collision_cost_pallas_factory(jtask)(jnp.asarray(q),
                                                    interpret=True)
    task = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    res = task.collision_residuals
    hold(res.obstacle_terms_lanes(torch.as_tensor(q), LAM),
         [np.asarray(r) for r in ref], "pair terms")
    hold([res.collision_cost_lanes(torch.as_tensor(q))],
         [np.asarray(ref_cost)], "pair cost")
