"""The planning task's tail vs the JAX package on the same numpy inputs,
at tests/test_tasks_parity.py's shapes: finite-difference velocities and
accelerations (robots/base.py), the 'rbf' fields and cost, the extra
objects' cost and fields, the collision-field accessor, ``sample_q``, the
collision / free split with its indices, and the intensity and success
scores.  Float32 op order: 1e-6 of max|ref| + 1e-5 relative (the rbf sums
1e-5 relative, the Gaussians of a few hundred points); flags, indices
and counts exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.costs import fields as jfields
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import \
    EnvDense2DExtraObjects as JEnvDense2DExtraObjects
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.costs import fields
from torch_robotics_tpu_torch.envs import (EnvDense2D, EnvDense2DExtraObjects,
                                           EnvSpheres3D)
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL, RBF_RTOL = 1e-6, 1e-5


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=TOL * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def panda():
    return (PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.03),
            JPlanningTask(env=JEnvSpheres3D(precompute_sdf_obj_fixed=False),
                          robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.03))


@pytest.fixture(scope="module")
def point_mass():
    return (PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=0.01),
            JPlanningTask(env=JEnvDense2D(precompute_sdf_obj_fixed=False),
                          robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01))


def test_finite_difference_states_match_jax(panda):
    """Positions alone (..., H, 7) take central differences for velocity
    and acceleration (zero at both ends); [q, qd] states keep their qd and
    difference it; [q, qd, qdd] keep both."""
    robot, jrobot = panda[0].robot, panda[1].robot
    rng = np.random.default_rng(3)
    for width in (7, 14, 21):
        x = rng.normal(size=(4, 8, width)).astype(np.float32)
        for name in ("get_velocity", "get_acceleration"):
            got = getattr(robot, name)(torch.as_tensor(x))
            _close(got, getattr(jrobot, name)(jnp.asarray(x)))
            if width == 7 or (width == 14 and name == "get_acceleration"):
                assert (got[:, 0] == 0).all() and (got[:, -1] == 0).all()


def test_rbf_fields_and_cost_match_jax(panda):
    """test_tasks_parity.py's two Panda configurations (and two more):
    the object and self rbf fields on the collision points, and the task's
    'rbf' cost at its cutoff margin and at another margin."""
    task, jtask = panda
    lo, hi = task.robot.q_min.numpy(), task.robot.q_max.numpy()
    q = np.stack([0.3 * (lo + hi), 0.5 * (lo + hi),
                  lo + 0.2 * (hi - lo), lo + 0.7 * (hi - lo)]).astype(
        np.float32)
    x = np.concatenate([q, np.zeros_like(q)], -1)
    obj, slf = task._collision_points(torch.as_tensor(q))
    jobj, jslf = jtask._collision_points(jnp.asarray(q))
    for m in (0.03, 0.2):
        _close(fields.object_collision_rbf(task.df_obj_list, obj, m),
               jfields.object_collision_rbf(jtask.df_obj_list, jobj, m),
               RBF_RTOL)
        _close(fields.self_collision_rbf(slf, m),
               jfields.self_collision_rbf(jslf, m), RBF_RTOL)
        _close(task.compute_collision_cost_rbf(torch.as_tensor(x), margin=m),
               jtask.compute_collision_cost_rbf(jnp.asarray(x), margin=m),
               RBF_RTOL)
    got = task.compute_collision_cost(torch.as_tensor(x), field_type="rbf")
    _close(got, jtask.compute_collision_cost(jnp.asarray(x),
                                             field_type="rbf"), RBF_RTOL)
    assert bool((got >= slf.shape[-2]).all())    # the diagonal's ones


def test_extra_objects_cost_and_fields_match_jax():
    """EnvDense2DExtraObjects with the point mass: the extra objects' own
    'sdf' cost (test_tasks_parity.py's two points and 64 seeded ones), the
    extra list in the task's object list, and a scene without extras."""
    task = PlanningTask(env=EnvDense2DExtraObjects(device="cpu"),
                        robot=RobotPointMass.create(device="cpu"),
                        obstacle_cutoff_margin=0.01)
    jtask = JPlanningTask(env=JEnvDense2DExtraObjects(),
                          robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01)
    assert len(task.get_collision_fields_extra_objects()) == len(
        jtask.get_collision_fields_extra_objects()) == 1
    assert len(task.df_obj_list) == len(jtask.df_obj_list) == 2
    x = np.concatenate([[[-0.4, 0.1], [0.9, 0.9]], np.random.default_rng(
        4).uniform(-1, 1, (64, 2))]).astype(np.float32)
    got = task.compute_collision_cost_extra_objects(torch.as_tensor(x))
    _close(got, jtask.compute_collision_cost_extra_objects(jnp.asarray(x)))
    assert float(got[0]) > float(got[1])
    _close(task.compute_collision_cost(torch.as_tensor(x)),
           jtask.compute_collision_cost(jnp.asarray(x)))
    plain = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"))
    assert plain.get_collision_fields_extra_objects() == []
    assert (plain.compute_collision_cost_extra_objects(
        torch.as_tensor(x)) == 0).all()


def test_collision_fields_match_jax(panda, point_mass):
    for task, jtask in (panda, point_mass):
        got, ref = task.get_collision_fields(), jtask.get_collision_fields()
        if ref["self"] is None:
            assert got["self"] is None
        else:
            np.testing.assert_array_equal(got["self"], ref["self"])
        assert len(got["objects"]) == len(ref["objects"])
        for a, b in zip(got["ws_bounds"], ref["ws_bounds"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_q(point_mass):
    """test_tasks_parity.py's budget (16 of 512): the free samples are the
    first free candidates of the generator's draw, free under the JAX
    package's check too; without the check, the robot's uniform draw."""
    task, jtask = point_mass
    samples, n_valid = task.sample_q(torch.Generator().manual_seed(0),
                                     n_samples=16, max_samples=512)
    cand = task.robot.random_q(torch.Generator().manual_seed(0), 512)
    free = cand[~task._compute_collision(cand)]
    assert n_valid == 16 and torch.equal(samples, free[:16])
    assert not np.asarray(jtask.compute_collision(
        jnp.asarray(samples.numpy()))).any()
    q = task.sample_q(torch.Generator().manual_seed(1),
                      without_collision=False, n_samples=8)
    assert torch.equal(q, task.robot.random_q(
        torch.Generator().manual_seed(1), n_samples=8))


def test_trajectory_split_and_scores_match_jax(point_mass):
    """test_tasks_parity.py's split: 16 point-mass trajectories of 8
    waypoints (seeded numpy, both packages the same draw): 8 with waypoints
    uniform in [-0.9, 0.9], 8 short lines (0.05 long) from uniform starts,
    with indices; a (2, 8) batch flattens as the reference's; the
    fraction free, the intensity and the success score."""
    task, jtask = point_mass
    rng = np.random.default_rng(1)
    lines = rng.uniform(-0.9, 0.9, (8, 1, 2)) + np.linspace(
        0.0, 0.05, 8)[:, None]
    trajs = np.concatenate([rng.uniform(-0.9, 0.9, (8, 8, 2)),
                            lines]).astype(np.float32)
    for shape in ((16, 8, 2), (2, 8, 8, 2)):
        t = trajs.reshape(shape)
        got = task.get_trajs_collision_and_free(torch.as_tensor(t),
                                                return_indices=True)
        ref = jtask.get_trajs_collision_and_free(jnp.asarray(t),
                                                 return_indices=True)
        for g, r in zip(got[:4], ref[:4]):
            assert (g is None) == (r is None)
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        assert 0 < len(got[1]) < 16
        coll, free = task.get_trajs_collision_and_free(torch.as_tensor(t))
        assert torch.equal(coll, got[0]) and torch.equal(free, got[2])
        for name in ("compute_fraction_free_trajs",
                     "compute_collision_intensity_trajs",
                     "compute_success_free_trajs"):
            a = getattr(task, name)(torch.as_tensor(t))
            b = getattr(jtask, name)(jnp.asarray(t))
            assert type(a) is type(b) and abs(a - b) < 1e-6, name
    assert task.compute_success_free_trajs(torch.as_tensor(
        np.zeros((3, 8, 2), np.float32))) == jtask.compute_success_free_trajs(
        jnp.zeros((3, 8, 2)))
