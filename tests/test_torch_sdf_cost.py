"""The port's 'sdf' cost (``PlanningTask._compute_cost``,
``compute_collision_cost``) and the cost functions under it
(``costs/fields.py``) against the JAX package.

- The cost, clamped (``clamp_sdf_cost``) and not, on the same q from a
  numpy seed with two leading batch dims, for the point mass in
  EnvDense2D, the planar 2-link arm in EnvPlanar2Link, the Panda in
  EnvSpheres3D and the Panda with the learned self-collision net (its net
  branch), to 1e-6 of max|ref| in float32; ``compute_collision_cost`` on
  states ('sdf' and 'occupancy') likewise.
- Its gradient (autograd, as MPOT's clearance step takes it) on the point
  mass matches ``jax.grad`` to 1e-6 of max|ref|.
- ``object_collision_cost``, ``self_collision_cost``,
  ``workspace_bounds_cost`` and ``interpolate_points_v2`` on random points
  to 1e-6 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.costs import fields as jfields
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvPlanar2Link as JEnvPlanar2Link
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPlanar2Link as JRobotPlanar2Link
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.costs import fields
from torch_robotics_tpu_torch.envs import (EnvDense2D, EnvPlanar2Link,
                                           EnvSpheres3D)
from torch_robotics_tpu_torch.robots import (RobotPanda, RobotPlanar2Link,
                                             RobotPointMass)
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL = 1e-6
ROBOTS = ("point_mass", "planar2link", "panda", "net_panda")


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _make(name):
    """(port env, port robot, JAX env, JAX robot, cutoff)."""
    if name == "point_mass":
        return (EnvDense2D(device="cpu"), RobotPointMass.create(device="cpu"),
                JEnvDense2D(), JRobotPointMass.create(), 0.02)
    if name == "planar2link":
        return (EnvPlanar2Link(device="cpu"),
                RobotPlanar2Link.create(device="cpu"), JEnvPlanar2Link(),
                JRobotPlanar2Link.create(), 0.01)
    net = name == "net_panda"
    return (EnvSpheres3D(device="cpu"),
            RobotPanda.create(use_learned_self_collision=net, device="cpu"),
            JEnvSpheres3D(),
            JRobotPanda.create(use_learned_self_collision=net), 0.03)


@pytest.fixture(scope="module", params=ROBOTS)
def case(request):
    env, robot, jenv, jrobot, cutoff = _make(request.param)
    tasks = {clamp: (PlanningTask(env=env, robot=robot,
                                  obstacle_cutoff_margin=cutoff,
                                  clamp_sdf_cost=clamp),
                     JPlanningTask(env=jenv, robot=jrobot,
                                   obstacle_cutoff_margin=cutoff,
                                   clamp_sdf_cost=clamp))
             for clamp in (False, True)}
    lo = np.asarray(jrobot.q_min, np.float64)
    hi = np.asarray(jrobot.q_max, np.float64)
    u = np.random.default_rng(0).uniform(size=(4, 16, lo.shape[0]))
    q = (lo + u * (hi - lo)).astype(np.float32)
    return tasks, q


@pytest.mark.parametrize("clamp", [False, True])
def test_sdf_cost_matches_jax(case, clamp):
    tasks, q = case
    task, jtask = tasks[clamp]
    ref = np.asarray(jax.jit(jtask._compute_cost)(jnp.asarray(q)))
    got = task._compute_cost(torch.as_tensor(q))
    _close(got, ref)
    if clamp:
        assert (ref >= 0).all() and (ref > 0).any()


@pytest.mark.parametrize("field_type", ["sdf", "occupancy"])
def test_compute_collision_cost_matches_jax(case, field_type):
    tasks, q = case
    task, jtask = tasks[False]
    x = np.concatenate([q, np.zeros_like(q)], -1)
    ref = np.asarray(jtask.compute_collision_cost(jnp.asarray(x),
                                                  field_type=field_type))
    got = task.compute_collision_cost(torch.as_tensor(x),
                                      field_type=field_type)
    assert got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("clamp", [False, True])
def test_sdf_cost_gradient_matches_jax(clamp):
    env, robot, jenv, jrobot, cutoff = _make("point_mass")
    task = PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=cutoff,
                        clamp_sdf_cost=clamp)
    jtask = JPlanningTask(env=jenv, robot=jrobot,
                          obstacle_cutoff_margin=cutoff, clamp_sdf_cost=clamp)
    q = np.random.default_rng(1).uniform(-1, 1, size=(512, 2)).astype(
        np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(jtask._compute_cost(x)))(
        jnp.asarray(q)))
    qt = torch.as_tensor(q).requires_grad_(True)
    got, = torch.autograd.grad(task._compute_cost(qt).sum(), qt)
    _close(got, ref)


def test_field_costs_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.2, 1.2, size=(3, 5, 9, 2)).astype(np.float32)
    margins = rng.uniform(0.0, 0.05, size=9).astype(np.float32)
    pairs = np.array([[0, 3], [1, 8], [2, 5], [4, 7]])
    pair_m = rng.uniform(0.1, 0.6, size=4).astype(np.float32)
    env, jenv = EnvDense2D(device="cpu"), JEnvDense2D()
    lo, hi = np.array([-1.0, -1.0], np.float32), np.array([1.0, 1.0],
                                                          np.float32)
    P, jP = torch.as_tensor(pts), jnp.asarray(pts)
    for clamp in (False, True):
        _close(fields.object_collision_cost(
            env.get_df_obj_list(), P, torch.as_tensor(margins), 0.01, clamp),
            jfields.object_collision_cost(
                jenv.get_df_obj_list(), jP, jnp.asarray(margins), 0.01,
                clamp))
        _close(fields.self_collision_cost(P, pairs, torch.as_tensor(pair_m),
                                          clamp),
               jfields.self_collision_cost(jP, pairs, jnp.asarray(pair_m),
                                           clamp))
        _close(fields.workspace_bounds_cost(
            P, torch.as_tensor(lo), torch.as_tensor(hi),
            torch.as_tensor(margins), 0.01, clamp),
            jfields.workspace_bounds_cost(jP, jnp.asarray(lo),
                                          jnp.asarray(hi),
                                          jnp.asarray(margins), 0.01, clamp))
    for n, rng_ in ((0, (1, 4)), (3, (1, 4)), (2, (0, 8))):
        _close(fields.interpolate_points_v2(P, n, rng_),
               jfields.interpolate_points_v2(jP, n, rng_))
