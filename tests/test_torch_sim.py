"""The port's execution harness (sim/rollout.py, sim/motion_planning_
controller.py) vs the JAX package's on the same plans: the point mass at
tests/test_sim.py's shapes (H = 32, a free line along EnvCircle2D's left
edge and a diagonal through EnvDense2D), and a Panda in EnvSpheres3D at
B = 16, H = 16 (straight lines between seeded joint draws, some through
obstacles).  q, qd and the tracking error at float32 op order (1e-5 of
max|ref| + 1e-5 relative: the same PD steps, XLA may fuse them), the
contact and frozen flags and the free count exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvCircle2D as JEnvCircle2D
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.sim import MotionPlanningController as JController
from torch_robotics_tpu.sim import PDControllerParams as JPDParams
from torch_robotics_tpu.sim import execute_trajectories as jax_execute
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvCircle2D, EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.sim import (MotionPlanningController,
                                          PDControllerParams,
                                          execute_trajectories)
from torch_robotics_tpu_torch.tasks import PlanningTask

TOL = 1e-5


def _close(got, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                               atol=TOL * float(np.abs(ref).max()))


def _same(got, ref):
    res, n_free = got
    jres, jn_free = ref
    for name in ("q", "qd", "tracking_error"):
        _close(getattr(res, name), getattr(jres, name))
    for name in ("contact", "frozen"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)))
    assert n_free == jn_free


def _point_mass(env, jenv):
    return (PlanningTask(env=env(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=0.01),
            JPlanningTask(env=jenv(precompute_sdf_obj_fixed=False),
                          robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01))


def test_point_mass_free_line_matches_jax():
    """tests/test_sim.py's free line: PD gains 100 / 20, the harness
    called directly with the task's collision check."""
    task, jtask = _point_mass(EnvCircle2D, JEnvCircle2D)
    H = 32
    pos = np.stack([np.full(H, -0.95), np.linspace(-0.9, 0.9, H)],
                   -1)[None].astype(np.float32)
    vel = (np.gradient(pos, axis=-2) / 0.04).astype(np.float32)
    kw = dict(kp=100.0, kd=20.0, dt=0.04, substeps=4)

    def jcoll(q):
        return jtask._compute_collision(q, margin_override=None)

    res = execute_trajectories(
        lambda q: task._compute_collision(q, margin_override=None),
        torch.as_tensor(pos), torch.as_tensor(vel), PDControllerParams(**kw))
    jres = jax_execute(jcoll, jnp.asarray(pos), jnp.asarray(vel),
                       JPDParams(**kw))
    assert not bool(res.frozen[0]) and float(res.tracking_error[0]) < 0.05
    _same((res, 1), (jres, 1))


def test_point_mass_controller_freezes_as_jax():
    """The diagonal through EnvDense2D: contact, then frozen in place."""
    task, jtask = _point_mass(EnvDense2D, JEnvDense2D)
    H = 32
    pos = np.stack([np.linspace(-0.9, 0.9, H)] * 2, -1)[None]
    state = np.concatenate([pos, np.gradient(pos, axis=-2) / 0.04],
                           -1).astype(np.float32)
    got = MotionPlanningController(task).run_trajectories(
        torch.as_tensor(state))
    ref = JController(jtask).run_trajectories(jnp.asarray(state))
    _same(got, ref)
    res = got[0]
    assert got[1] == 0 and bool(res.contact.any())
    t0 = int(np.argmax(res.contact[0].numpy()))
    assert (res.q[0, t0 + 1:] == res.q[0, t0]).all()
    assert (res.qd[0, t0 + 1:] == 0).all()


@pytest.mark.parametrize("with_velocity", [True, False])
def test_panda_plans_match_jax(with_velocity):
    """16 straight-line Panda plans of 16 waypoints between seeded free
    draws in the joint box: the controller on [q, qd] states, and on
    positions alone (finite-difference velocities at the robot's dt);
    some plans freeze on contact, some run free."""
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(device="cpu"),
                        obstacle_cutoff_margin=0.03)
    jtask = JPlanningTask(env=JEnvSpheres3D(precompute_sdf_obj_fixed=False),
                          robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.03)
    lo, hi = task.robot.q_min.numpy(), task.robot.q_max.numpy()
    pool = lo + np.random.default_rng(7).uniform(0.1, 0.9, (512, 7)) * (
        hi - lo)
    free = pool[~task._compute_collision(
        torch.as_tensor(pool, dtype=torch.float32)).numpy()]
    q0, q1 = free[:16], free[16:32]
    s = np.linspace(0.0, 1.0, 16)[None, :, None]
    pos = q0[:, None] + s * (q1 - q0)[:, None]
    vel = np.broadcast_to((q1 - q0)[:, None] / (15 * 0.04), pos.shape)
    x = (np.concatenate([pos, vel], -1) if with_velocity else pos).astype(
        np.float32)
    got = MotionPlanningController(task).run_trajectories(torch.as_tensor(x))
    ref = JController(jtask).run_trajectories(jnp.asarray(x))
    _same(got, ref)
    assert 0 < got[1] < 16
