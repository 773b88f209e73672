"""The collision-check building blocks of the iLQR path vs the JAX package
on the same numpy inputs: the distance fields (costs/fields.py), waypoint
interpolation (trajectory/utils.py) and the robot's state and Jacobian
helpers (robots/base.py).  Float32 op order: 1e-6 of max|ref| + 1e-6
relative; flags and selections exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.costs import fields as jfields
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.trajectory.utils import \
    interpolate_traj_via_points as jax_interp
from torch_robotics_tpu_torch.costs import fields
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.trajectory import interpolate_traj_via_points

TOL = 1e-6


@pytest.fixture(scope="module")
def scene():
    jenv, jrobot = JEnvSpheres3D(), JRobotPanda.create()
    env, robot = EnvSpheres3D(device="cpu"), RobotPanda.create(device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, size=(6, 5, 3)).astype(np.float32)
    return jenv, jrobot, env, robot, pts


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                               atol=TOL * float(np.abs(ref).max()))


def test_object_fields_match_jax(scene):
    jenv, jrobot, env, robot, pts = scene
    sd = fields.object_signed_distances(env.get_df_obj_list(),
                                        torch.as_tensor(pts))
    _close(sd, jfields.object_signed_distances(jenv.get_df_obj_list(),
                                               jnp.asarray(pts)))
    for cutoff in (0.0, 0.06):
        got = fields.object_collision_any(env.get_df_obj_list(),
                                          torch.as_tensor(pts), 0.05,
                                          cutoff_margin=cutoff)
        ref = jfields.object_collision_any(jenv.get_df_obj_list(),
                                           jnp.asarray(pts), 0.05,
                                           cutoff_margin=cutoff)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_self_and_workspace_fields_match_jax(scene):
    _, jrobot, _, robot, pts = scene
    pairs = np.asarray([[0, 1], [0, 3], [2, 4], [1, 1]])
    got = fields.self_collision_distances(torch.as_tensor(pts), pairs)
    _close(got, jfields.self_collision_distances(jnp.asarray(pts), pairs))
    assert float(got[..., 3].abs().max()) == 0.0          # zero-length pair
    flags = fields.self_collision_any(torch.as_tensor(pts), pairs, 0.6)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(
        jfields.self_collision_any(jnp.asarray(pts), pairs, 0.6)))
    lo, hi = np.asarray([-0.5, -0.6, -0.2]), np.asarray([0.6, 0.5, 0.7])
    got = fields.workspace_bounds_distances(torch.as_tensor(pts),
                                            torch.as_tensor(lo),
                                            torch.as_tensor(hi))
    _close(got, jfields.workspace_bounds_distances(jnp.asarray(pts), lo, hi))
    for cutoff in (0.0, 0.06):
        flags = fields.workspace_bounds_any(
            torch.as_tensor(pts), torch.as_tensor(lo), torch.as_tensor(hi),
            0.05, cutoff_margin=cutoff)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(
            jfields.workspace_bounds_any(jnp.asarray(pts), lo, hi, 0.05,
                                         cutoff_margin=cutoff)))


@pytest.mark.parametrize("n", [0, 1, 5])
def test_interpolate_traj_via_points_matches_jax(n):
    trajs = np.random.default_rng(1).normal(size=(3, 2, 6, 7)).astype(
        np.float32)
    _close(interpolate_traj_via_points(torch.as_tensor(trajs), n),
           jax_interp(jnp.asarray(trajs), n))


def test_robot_helpers_match_jax(scene):
    _, jrobot, _, robot, _ = scene
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3, 14)).astype(np.float32)
    _close(robot.get_velocity(torch.as_tensor(x)),
           jrobot.get_velocity(jnp.asarray(x)))
    _close(robot.distance_q(torch.as_tensor(x[..., :7]),
                            torch.as_tensor(x[..., 7:])),
           jrobot.distance_q(jnp.asarray(x[..., :7]), jnp.asarray(x[..., 7:])))
    J = rng.normal(size=(4, robot.model.n_links, 3, 7)).astype(np.float32)
    for idxs in (robot.object_coll_idxs, robot.self_coll_idxs):
        got = robot.select_collision_jacobians(torch.as_tensor(J), idxs)
        ref = jrobot.select_collision_jacobians(jnp.asarray(J), idxs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(NotImplementedError):
        robot.select_collision_jacobians(torch.as_tensor(J), idxs,
                                         interpolate=True, num_interp=2)
    with pytest.raises(NotImplementedError):
        robot.get_velocity(torch.as_tensor(x[..., :7]))


def test_random_q_is_uniform_in_the_limits_and_seeded(scene):
    robot = scene[3]
    q = robot.random_q(torch.Generator().manual_seed(3), n_samples=4096)
    assert q.shape == (4096, 7)
    assert bool(((q >= robot.q_min) & (q <= robot.q_max)).all())
    u = (q - robot.q_min) / (robot.q_max - robot.q_min)
    assert float((u.mean(0) - 0.5).abs().max()) < 0.02
    assert torch.equal(q, robot.random_q(torch.Generator().manual_seed(3),
                                         n_samples=4096))


def test_occupancy_maps_are_not_ported(scene):
    _, _, env, robot, _ = scene
    with pytest.raises(NotImplementedError):
        PlanningTask(env=env, robot=robot, use_occupancy_map=True)
