"""The port's MuJoCo execution adapter (sim/mujoco_adapter.py; mujoco runs
on the host): tests/test_mujoco_adapter.py's cases on the port, and the
port's compiled MjModel and executions held to the JAX package's on the
same robot, scene and trajectories: the model arrays to 1e-6, the
contacts and contact steps exactly, the executed joint positions to
1e-5."""
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

import jax.numpy as jnp  # noqa: E402

from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D  # noqa
from torch_robotics_tpu.geom.sdf import ObjectField as JObjectField  # noqa
from torch_robotics_tpu.geom.sdf import Spheres as JSpheres  # noqa: E402
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda  # noqa: E402
from torch_robotics_tpu.sim.mujoco_adapter import \
    MujocoExecutionEnv as JMujocoExecutionEnv  # noqa: E402
from torch_robotics_tpu_torch.envs import EnvSpheres3D  # noqa: E402
from torch_robotics_tpu_torch.envs import EnvTableShelf  # noqa: E402
from torch_robotics_tpu_torch.geom.sdf import ObjectField, Spheres  # noqa
from torch_robotics_tpu_torch.robots import RobotPanda  # noqa: E402
from torch_robotics_tpu_torch.sim import MujocoExecutionEnv  # noqa: E402
from torch_robotics_tpu_torch.tasks import PlanningTask  # noqa: E402

MODEL_ARRAYS = ("body_pos", "body_quat", "jnt_axis", "jnt_range",
                "geom_size", "geom_pos", "actuator_gainprm")
CENTER, RADIUS = (0.55, 0.0, 0.55), 0.16


class _SingleSphereEnv:
    """One obstacle sphere in the Panda's workspace (the port's, or the
    JAX package's with ``jax``)."""

    obj_extra_list = None

    def __init__(self, center=CENTER, radius=RADIUS, jax=False):
        if jax:
            self.obj = JObjectField.create([JSpheres(
                centers=jnp.asarray([center]), radii=jnp.asarray([radius]))])
        else:
            self.obj = ObjectField.create([Spheres(
                centers=torch.tensor([center]), radii=torch.tensor([radius]))],
                device="cpu")

    def get_df_obj_list(self):
        return [self.obj]


@pytest.fixture(scope="module")
def panda():
    return RobotPanda.create(device="cpu")


def _sweep(H=24):
    """A shoulder sweep from left to right through the sphere's azimuth."""
    traj = np.zeros((1, H, 7))
    traj[0, :, 0] = np.linspace(-0.9, 0.9, H)
    traj[0, :, 1] = 0.5           # reach forward
    traj[0, :, 3] = -1.2
    return traj


# --- tests/test_mujoco_adapter.py's cases on the port -----------------------
def test_model_builds(panda):
    mj = MujocoExecutionEnv(panda, EnvSpheres3D(device="cpu"))
    assert mj.mj_model.nq == 7
    assert mj.mj_model.nu == 7
    assert mj.mj_model.ngeom > 30     # robot spheres and obstacles


def test_hold_neutral_is_contact_free(panda):
    mj = MujocoExecutionEnv(panda, _SingleSphereEnv(center=(0.9, 0.9, 0.9)))
    res = mj.run_trajectories(np.zeros((1, 6, 7)), dt_plan=0.04)
    assert not bool(res.contact[0])
    assert res.tracking_err[0] < 0.08


def test_sweep_through_obstacle_reports_contact(panda):
    """A sweep that the task's SDF flags as colliding makes physical contact
    in MuJoCo too."""
    env = _SingleSphereEnv()
    task = PlanningTask(env=env, robot=panda, ws_limits=[[-2, -2, -2],
                                                        [2, 2, 2]],
                        obstacle_cutoff_margin=0.0)
    traj = _sweep()
    x = torch.cat([torch.as_tensor(traj[0], dtype=torch.float32),
                   torch.zeros((traj.shape[1], 7))], -1)
    assert bool(task.compute_collision(x).any())
    res = MujocoExecutionEnv(panda, env).run_trajectories(
        torch.as_tensor(traj), dt_plan=0.08)
    assert bool(res.contact[0])
    assert res.contact_step[0] >= 0


def test_contact_freezes_robot(panda):
    """After first contact the servo target stops advancing."""
    traj = _sweep()
    res = MujocoExecutionEnv(panda, _SingleSphereEnv()).run_trajectories(
        traj, dt_plan=0.08)
    assert bool(res.contact[0])
    k = int(res.contact_step[0])
    final_q0 = res.qpos_executed[0, -1, 0]
    assert abs(final_q0 - traj[0, -1, 0]) > 0.3
    assert abs(final_q0 - traj[0, k, 0]) < 0.3


# --- against the JAX package's adapter --------------------------------------
@pytest.fixture(scope="module", params=["spheres3d", "table_shelf"])
def pair(request):
    """(the port's adapter, the JAX package's) of the Panda in a scene of
    spheres or of the shelf's boxes."""
    from torch_robotics_tpu.envs import EnvTableShelf as JEnvTableShelf
    env, jenv = {"spheres3d": (EnvSpheres3D, JEnvSpheres3D),
                 "table_shelf": (EnvTableShelf, JEnvTableShelf)}[
        request.param]
    return (MujocoExecutionEnv(RobotPanda.create(device="cpu"),
                               env(device="cpu")),
            JMujocoExecutionEnv(JRobotPanda.create(), jenv()))


def test_compiled_models_match_jax(pair):
    mj, jmj = pair
    for name in MODEL_ARRAYS:
        a, b = getattr(mj.mj_model, name), getattr(jmj.mj_model, name)
        assert a.shape == b.shape and a.size > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
    assert mj.joint_names == jmj.joint_names
    assert mj.dof_order == jmj.dof_order


def test_executions_match_jax(panda):
    """The sweep (contact), the neutral hold and a reach (free) executed by
    both adapters: contacts and contact steps exactly, qpos to 1e-5."""
    trajs = np.concatenate([
        _sweep(), np.zeros((1, 24, 7)),
        np.linspace(np.zeros(7), [0.4, -0.3, 0.2, -1.0, 0.1, 0.8, 0.3],
                    24)[None]])
    res = MujocoExecutionEnv(panda, _SingleSphereEnv()).run_trajectories(
        torch.as_tensor(trajs), dt_plan=0.08)
    ref = JMujocoExecutionEnv(JRobotPanda.create(),
                              _SingleSphereEnv(jax=True)).run_trajectories(
        trajs, dt_plan=0.08)
    np.testing.assert_array_equal(res.contact, ref.contact)
    np.testing.assert_array_equal(res.contact_step, ref.contact_step)
    assert res.contact.tolist() == [True, False, False]
    np.testing.assert_allclose(res.qpos_executed, ref.qpos_executed,
                               rtol=0, atol=1e-5)
