"""The port's RRT-Connect (``solve/rrt.py``) and spline smoothing
(``trajectory/utils.py``) against the JAX package.

- ``_rrt_connect_from_samples``, fed the JAX package's own pre-samples
  (``random_coll_free_q(PRNGKey(0), ...)``), returns the JAX
  ``rrt_connect`` path node for node (tests/test_solve_rrt.py's EnvDense2D
  problem, max_time 60): the tree bookkeeping is the reference's numpy, the
  kd-tree the same C++ and the segment checks the same collision function.
- The port's own ``rrt_connect`` (its generator's pre-samples) finds a
  path that meets tests/test_solve_rrt.py's assertions.
- The clamped spline matches JAX to 1e-6 of max|y| in float32 and 1e-10 in
  float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import RRTConnectParams as JRRTConnectParams
from torch_robotics_tpu.solve import rrt_connect as jax_rrt_connect
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu.trajectory.utils import \
    smoothen_trajectory as jax_smoothen
from torch_robotics_tpu_torch.envs import EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.solve import RRTConnectParams, rrt_connect
from torch_robotics_tpu_torch.solve.rrt import _rrt_connect_from_samples
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.trajectory import smoothen_trajectory

RRT = dict(n_iters=2000, n_radius=0.3, n_pre_samples=4096, max_time=60.0)
START = np.array([-0.9, -0.9], np.float32)
GOAL = np.array([0.9, 0.9], np.float32)


@pytest.fixture(scope="module")
def tasks():
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.005)
    ptask = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=0.005)
    return jtask, ptask


def test_tree_loop_matches_jax_node_for_node_on_its_samples(tasks):
    jtask, ptask = tasks
    jpath = jax_rrt_connect(jtask, START, GOAL, JRRTConnectParams(**RRT))
    assert jpath is not None
    samples, n_valid = jtask.random_coll_free_q(
        jax.random.PRNGKey(0), n_samples=min(RRT["n_pre_samples"], 8192),
        max_samples=RRT["n_pre_samples"])
    samples = np.asarray(samples)[:int(n_valid)]
    stats = {}
    path = _rrt_connect_from_samples(ptask, START, GOAL, samples,
                                     RRTConnectParams(**RRT), stats)
    assert path is not None and path.dtype == np.float32
    assert path.shape == jpath.shape
    np.testing.assert_array_equal(path, np.asarray(jpath))
    assert stats["n_checks"] >= len(path) - 2 and stats["n_iters"] >= 1


def test_rrt_connect_finds_a_free_path(tasks):
    """tests/test_solve_rrt.py's assertions on the port's own draw."""
    _, ptask = tasks
    params = RRTConnectParams(**RRT)
    stats = {}
    path = rrt_connect(ptask, START, GOAL, params, stats=stats)
    assert path is not None
    np.testing.assert_allclose(path[0], START, atol=1e-5)
    np.testing.assert_allclose(path[-1], GOAL, atol=1e-5)
    assert not bool(ptask.compute_collision(torch.as_tensor(path)).any())
    seg = np.linalg.norm(np.diff(path, axis=0), axis=-1)
    assert float(seg.max()) <= params.n_radius + 1e-5
    assert set(stats) >= {"n_checks", "check_s", "n_iters", "sample_s"}


def test_rrt_params_from_the_scene_presets():
    """from_preset and get_rrt_connect_params as the JAX package's, for the
    point mass in EnvDense2D and the Panda in EnvSpheres3D; a preset for
    another robot raises, and has_preset says so."""
    for env, jenv, robot in (
            (EnvDense2D(device="cpu"), JEnvDense2D(),
             RobotPointMass.create(device="cpu")),
            (EnvSpheres3D(device="cpu"), JEnvSpheres3D(),
             RobotPanda.create(device="cpu"))):
        preset = env.get_rrt_connect_params(robot)
        assert preset == jenv.get_rrt_connect_params(robot)
        ours = RRTConnectParams.from_preset(preset)
        theirs = JRRTConnectParams.from_preset(preset)
        assert ours.__dict__ == theirs.__dict__
        assert env.has_preset("rrt_connect", robot)
    env = EnvSpheres3D(device="cpu")
    pm = RobotPointMass.create(device="cpu")
    assert not env.has_preset("rrt_connect", pm)
    assert not env.has_preset("chomp", RobotPanda.create(device="cpu"))
    with pytest.raises(NotImplementedError, match="is for RobotPanda"):
        env.get_rrt_connect_params(pm)


def _path(n, d, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(n, d)) * 0.2, axis=0)


@pytest.mark.parametrize("n,H,avg", [(22, 64, True), (5, 48, False),
                                     (2, 16, True), (1, 8, True)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-10)])
def test_spline_matches_jax(n, H, avg, dtype, tol):
    y = _path(n, 3, seed=n).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jpos, jvel = jax_smoothen(jnp.asarray(y), n_support_points=H,
                                  dt=0.04, set_average_velocity=avg)
        jpos, jvel = np.asarray(jpos), np.asarray(jvel)
    pos, vel = smoothen_trajectory(torch.as_tensor(y), n_support_points=H,
                                   dt=0.04, set_average_velocity=avg)
    assert pos.dtype == vel.dtype == torch.from_numpy(y).dtype
    scale = max(np.abs(jpos).max(), np.abs(jvel).max(), 1.0)
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(vel.numpy(), jvel, rtol=0, atol=tol * scale)
    # the clamped spline passes through its end knots
    np.testing.assert_allclose(pos[[0, -1]].numpy(), y[[0, -1]] if n > 1
                               else y[[0, 0]], atol=tol * scale)
