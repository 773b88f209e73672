"""The port's chained MPC step vs the JAX package in float64 at the main
path's horizon (B = 32, H = 64, the bench's GPMP2Params).

At these weights (lam = 1/sigma_coll^2 = 1e8) a float32 MPC step of two
chained GN iterations is ill-conditioned: a correct float32 run differs
from a float64 run by up to ~0.25 of max|theta| on a few lanes, in the JAX
package as in the port, so no float32 comparison at this size can hold the
port to 1e-3.  In float64 the two packages compute the same function to
~1e-10 of max|theta|; this test holds the port's algorithm there.

Run as a script, from the root of a checkout, to print the float32 and
float64 gaps as one JSON line:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_mpc_float64.py
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            mpc_step, straight_line_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask

B, H = 32, 64
GP = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
          sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
          step_size=1.0)
# float64 op-order differences (~1e-16) amplified by the step's
# conditioning (~1e6, the float32 gap over float32 rounding) give ~1e-10
TOL_F64 = 1e-7


def _start_goal():
    """bench.py's start/goal draw (numpy seed 0, the first B of 1024)."""
    model = RobotPanda.create(device="cpu").model
    rng = np.random.default_rng(0)
    lo = model.q_lower.astype(np.float64)
    hi = model.q_upper.astype(np.float64)
    u1 = rng.uniform(size=(1024, 7))[:B]
    u2 = rng.uniform(size=(1024, 7))[:B]
    q_start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    start = np.concatenate([q_start, 0 * q_start], -1).astype(np.float32)
    goal = np.concatenate([q_goal, 0 * q_goal], -1).astype(np.float32)
    return start, goal


def chained_thetas(dtype):
    """One MPC step (2 GN iterations) from the straight-line plan through
    the JAX package and the port, both in ``dtype`` -> (jax, port) theta
    (B, H, 14) as float64 numpy."""
    start, goal = _start_goal()
    f64 = dtype == np.float64
    with jax.enable_x64(f64):
        jtask = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                              obstacle_cutoff_margin=0.03)
        jgp = JGPMP2Params(**GP)
        s_j, g_j = jnp.asarray(start, dtype), jnp.asarray(goal, dtype)
        theta0 = np.asarray(straight_line_trajs(
            torch.as_tensor(start), torch.as_tensor(goal), H)).astype(dtype)
        j_state, _ = jax.jit(lambda st, g: jax_mpc_step(
            jtask.collision_residuals, st, g,
            JMPCParams(gpmp2=jgp, iters_per_step=2)))(
                JMPCState(theta=jnp.asarray(theta0), x=s_j), g_j)
        j_theta = np.asarray(j_state.theta, np.float64)
    tdt = torch.float64 if f64 else torch.float32
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.03)
    p_state, _ = mpc_step(
        ptask.collision_residuals,
        MPCState(theta=torch.as_tensor(theta0, dtype=tdt),
                 x=torch.as_tensor(start, dtype=tdt)),
        torch.as_tensor(goal, dtype=tdt),
        MPCParams(gpmp2=GPMP2Params(**GP), iters_per_step=2))
    return j_theta, p_state.theta.double().numpy()


def test_chained_mpc_step_matches_jax_in_float64():
    j_theta, p_theta = chained_thetas(np.float64)
    assert p_theta.shape == (B, H, 14) and np.isfinite(p_theta).all()
    np.testing.assert_allclose(p_theta, j_theta,
                               atol=TOL_F64 * np.abs(j_theta).max())


if __name__ == "__main__":
    j64, p64 = chained_thetas(np.float64)
    j32, p32 = chained_thetas(np.float32)
    scale = float(np.abs(p64).max())

    def gap(a, b):
        lane = np.abs(a - b).reshape(B, -1).max(1) / scale
        return {"max": float(lane.max()), "median_lane": float(np.median(lane)),
                "lanes_within_1e-3": int((lane <= 1e-3).sum())}

    print(json.dumps({"B": B, "H": H, "rel_to_max_theta": {
        "jax64_vs_port64": gap(j64, p64), "jax32_vs_port32": gap(j32, p32),
        "port32_vs_port64": gap(p32, p64), "jax32_vs_port64": gap(j32, p64)}}))
