"""Five Pandas' MPC step (chip_smoke.py's phase ``mr_five``: five Pandas on
a circle of 0.6 m at z = -0.7, each facing its centre, EnvSpheres3D at
cutoff 0.02, d = 35, m = 70) against the JAX package on the CPU: one
``mpc_step`` (2 GN iterations, config 4's GPMP2Params at H = 8) from the
straight-line plans between seeded starts and goals in the joint box, B =
2, in float64, held at 1e-8 of max|theta| (tests/test_torch_mpc_multi.py's
yardstick: the GN systems at lam = 1e6 are ill-conditioned, and float64 is
where the two packages compute the same function).  The JAX side is
jitted; on the CPU it solves m = 70 with its tiled block solver and the
port with its plain lanes sweep (on the card: the column sweep's
shared-memory route)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_mr_five import POSES
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            mpc_step, straight_line_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask

B, H = 2, 8
GP = dict(n_support_points=H, dt=0.05, sigma_start=1e-3, sigma_gp=1e-1,
          sigma_goal_prior=1e-3, sigma_coll=1e-3, step_size=0.7)
TOL_F64 = 1e-8


def test_mpc_step_matches_jax_in_float64():
    robot = MultiRobot.create(
        [RobotPanda.create(device="cpu") for _ in POSES],
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
          torch.tensor(t, dtype=torch.float32)) for t, yaw in POSES])
    task = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.02)
    rng = np.random.default_rng(5)
    lo, hi = robot.q_min.numpy(), robot.q_max.numpy()
    q0 = lo + rng.uniform(0.3, 0.7, size=(B, 35)) * (hi - lo)
    qg = np.clip(q0 + 0.4 * rng.normal(size=q0.shape), lo, hi)
    start, goal = (np.concatenate([q, np.zeros_like(q)], -1)
                   for q in (q0, qg))
    theta0 = straight_line_trajs(torch.as_tensor(start),
                                 torch.as_tensor(goal), H)
    with jax.enable_x64(True):
        jrobot = JMultiRobot.create(
            [JRobotPanda.create() for _ in POSES],
            [(jz_rot(jnp.array(yaw, jnp.float32)), jnp.array(t, jnp.float32))
             for t, yaw in POSES])
        jtask = JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                              obstacle_cutoff_margin=0.02)
        j_state, _ = jax.jit(lambda st, g: jax_mpc_step(
            jtask.collision_residuals, st, g,
            JMPCParams(gpmp2=JGPMP2Params(**GP), iters_per_step=2)))(
                JMPCState(theta=jnp.asarray(theta0.numpy()),
                          x=jnp.asarray(start)), jnp.asarray(goal))
        j_theta = np.asarray(j_state.theta, np.float64)
    p_state, _ = mpc_step(
        task.collision_residuals,
        MPCState(theta=theta0, x=torch.as_tensor(start)),
        torch.as_tensor(goal),
        MPCParams(gpmp2=GPMP2Params(**GP), iters_per_step=2))
    p_theta = p_state.theta.numpy()
    assert p_theta.dtype == np.float64 and p_theta.shape == (B, H, 70)
    assert np.isfinite(p_theta).all()
    assert np.abs(p_theta - theta0.numpy()).max() > 1e-3     # it moved
    np.testing.assert_allclose(p_theta, j_theta, rtol=0,
                               atol=TOL_F64 * np.abs(j_theta).max())
