"""The port's planar 2-link arm (``robots/planar2link.py``), its URDF model
(``kin/robot_zoo.planar_2_link``), its scene (``EnvPlanar2Link``) and its
interpolated collision points against the JAX package.

- The robot's limits, margins and point count equal the JAX package's.
- The three link points, their closed-form Jacobians, the 12 interpolated
  object points and their interpolated Jacobians match on the same q, at
  several leading shapes, to 1e-6 of max|ref| in float32; the interpolated
  Jacobians also match ``torch.func.jacfwd`` of the interpolated points.
- The URDF model's links and limits are the JAX package's and its FK
  matches to 1e-6.
- tests/test_planar2link_task.py's checks: the arm along +y through the
  sphere at (0.2, 0.5) collides and costs more than the arm along -y; the
  collision checks of both packages agree on random q.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvPlanar2Link as JEnvPlanar2Link
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu.kin.fk import fk_all_links as jax_fk_all_links
from torch_robotics_tpu.robots import RobotPlanar2Link as JRobotPlanar2Link
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvPlanar2Link, available_envs
from torch_robotics_tpu_torch.kin import robot_zoo
from torch_robotics_tpu_torch.kin.fk import fk_all_links
from torch_robotics_tpu_torch.robots import RobotPlanar2Link
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL = 1e-6


@pytest.fixture(scope="module")
def robots():
    return RobotPlanar2Link.create(device="cpu"), JRobotPlanar2Link.create()


@pytest.fixture(scope="module")
def tasks(robots):
    robot, jrobot = robots
    return (PlanningTask(env=EnvPlanar2Link(device="cpu"), robot=robot,
                         obstacle_cutoff_margin=0.01),
            JPlanningTask(env=JEnvPlanar2Link(), robot=jrobot,
                          obstacle_cutoff_margin=0.01))


def _q(shape, seed=0):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, size=shape + (2,)).astype(np.float32)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def test_create_matches_jax(robots):
    robot, jrobot = robots
    _close(robot.q_min, jrobot.q_min, 0)
    _close(robot.q_max, jrobot.q_max, 0)
    _close(robot.object_margins, jrobot.object_margins, 0)
    assert robot.object_margins.shape == (12,)
    assert robot.object_num_interp == jrobot.object_num_interp == 12
    assert robot.object_interpolate and robot.ws_dim == 2
    assert "EnvPlanar2Link" in available_envs()


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)])
def test_points_and_jacobians_match_jax(robots, shape):
    robot, jrobot = robots
    q = _q(shape)
    qt, qj = torch.as_tensor(q), jnp.asarray(q)
    _close(robot.fk_map_collision(qt), jrobot.fk_map_collision(qj))
    pts, J = robot.fk_map_collision_with_jac(qt)
    jpts, jJ = jrobot.fk_map_collision_with_jac(qj)
    _close(pts, jpts)
    _close(J, jJ)
    _close(robot.object_collision_points(pts),
           jrobot.object_collision_points(jpts))
    args = (robot.object_coll_idxs, True, robot.object_num_interp)
    _close(robot.select_collision_jacobians(J, *args),
           jrobot.select_collision_jacobians(jJ, *args))


def test_interpolated_jacobians_match_jacfwd(robots):
    robot, _ = robots
    q = torch.as_tensor(_q((16,), seed=1))

    def points(qi):
        return robot.object_collision_points(robot.fk_map_collision(qi))

    J_ad = torch.func.vmap(torch.func.jacfwd(points))(q)       # (N, 12, 2, 2)
    _, J = robot.fk_map_collision_with_jac(q)
    J_sel = robot.select_collision_jacobians(
        J, robot.object_coll_idxs, True, robot.object_num_interp)
    assert J_ad.dtype == torch.float32
    _close(J_sel, J_ad.numpy())


def test_urdf_model_matches_jax():
    model, jmodel = robot_zoo.planar_2_link(device="cpu"), \
        jzoo.planar_2_link()
    assert model.n_dofs == jmodel.n_dofs == 2
    assert tuple(model.link_names) == tuple(jmodel.link_names)
    _close(model.q_lower, jmodel.q_lower, 0)
    _close(model.q_upper, jmodel.q_upper, 0)
    q = _q((9,), seed=2) * 0.9
    _close(fk_all_links(model, torch.as_tensor(q)),
           jax_fk_all_links(jmodel, jnp.asarray(q)))


def test_task_collision_and_cost(tasks):
    task, jtask = tasks
    q_hit = torch.tensor([[np.pi / 2, 0.0]])
    q_free = torch.tensor([[-np.pi / 2, 0.0]])
    assert bool(task.compute_collision(q_hit)[0])
    assert (float(task.compute_collision_cost(q_hit)[0])
            > float(task.compute_collision_cost(q_free)[0]))
    q = _q((64,), seed=3)
    got = task.compute_collision(torch.as_tensor(q)).numpy()
    ref = np.asarray(jax.jit(jtask.compute_collision)(jnp.asarray(q)))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)
