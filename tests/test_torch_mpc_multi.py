"""The port's GN step, MPC step and MPC rollout on the config-4 embodiment
(benchmarks/run_all.py config_multi_robot: Panda, Panda, UR10 in
EnvSpheres3D, its GPMP2Params) vs the JAX package, at B = 4, H = 8, on the
same numpy inputs.

Why float64 is the yardstick: the collision weight lam = 1/sigma_coll^2
= 1e6 makes the m = 40 GN systems ill-conditioned, so two correct float32
runs that sum in another order (the port's plain sweep and JAX's tiled
solver, which the JAX step takes for m > 32 on the CPU) differ far above
float32 rounding (5.8e-6 of max|theta| after one MPC step here, ~50x the
float32 epsilon; ~1e-4 at H = 32 on the path's draw), and chained steps
amplify that.  In float64 the two packages compute the same function, so
they are held together there, at 1e-8 of max|theta| with no relative
slack (they agree to ~5e-15).  A float32 MPC step is checked at a
moderate sigma_coll = 1e-2 (lam = 1e4), at 1e-4 of max|theta|.

Run as a script, from the root of a checkout, to print the float32 and
float64 gaps at the path's weights as one JSON line:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_mpc_multi.py
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multi_robot import (CONFIG4, export_jax_multirobot_task,
                                    jax_task)
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.gpmp2 import gpmp2_step as jax_gpmp2_step
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_rollout as jax_mpc_rollout
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            gpmp2_step, mpc_rollout,
                                            mpc_step, straight_line_trajs)

B, H, N_STEPS = 4, 8, 3
# config 4's GPMP2Params at H = 8
GP = dict(n_support_points=H, dt=0.05, sigma_start=1e-3, sigma_gp=1e-1,
          sigma_goal_prior=1e-3, sigma_coll=1e-3, step_size=0.7)
TOL_F64 = 1e-8
TOL_F32, SIGMA_COLL_F32 = 1e-4, 1e-2


def _start_goal(robot):
    """Starts uniform in the joint box (most collide: the GN terms are
    busy), goals clip(q0 + 0.4 N(0, 1)) as config 4 draws them."""
    rng = np.random.default_rng(0)
    lo, hi = robot.q_min.numpy(), robot.q_max.numpy()
    q0 = lo + rng.uniform(0.3, 0.7, size=(B, lo.shape[0])) * (hi - lo)
    qg = np.clip(q0 + 0.4 * rng.normal(size=q0.shape), lo, hi)
    z = np.zeros_like(q0)
    return (np.concatenate([q0, z], -1).astype(np.float32),
            np.concatenate([qg, z], -1).astype(np.float32))


@pytest.fixture(scope="module")
def problem():
    jtask = jax_task(CONFIG4)
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    start, goal = _start_goal(ptask.robot)
    return jtask, ptask, start, goal


def _port(fn, dtype, *arrays):
    return fn(*[torch.as_tensor(a, dtype=dtype) for a in arrays])


def run_both(problem, which, dtype, gp=GP):
    """One of "gpmp2_step", "mpc_step", "mpc_rollout" through JAX and the
    port in ``dtype`` -> (jax, port) lists of float64 numpy outputs."""
    jtask, ptask, start, goal = problem
    theta0 = straight_line_trajs(torch.as_tensor(start),
                                 torch.as_tensor(goal), H).numpy()
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jp, pp = JGPMP2Params(**gp), GPMP2Params(**gp)
    jm, pm = (JMPCParams(gpmp2=jp, iters_per_step=2),
              MPCParams(gpmp2=pp, iters_per_step=2))
    res = ptask.collision_residuals
    with jax.enable_x64(dtype == np.float64):
        ja = [jnp.asarray(a, dtype) for a in (theta0, start, goal)]
        if which == "gpmp2_step":
            ref = jax.jit(lambda th, s, g: jax_gpmp2_step(
                jtask.collision_residuals, th, s, g, jp))(*ja)
            got = _port(lambda th, s, g: gpmp2_step(res, th, s, g, pp), tdt,
                        theta0, start, goal)
        elif which == "mpc_step":
            j_state, j_info = jax.jit(lambda th, s, g: jax_mpc_step(
                jtask.collision_residuals, JMPCState(theta=th, x=s), g,
                jm))(*ja)
            ref = (j_state.theta, j_state.x, j_info["dist_to_goal"])
            p_state, p_info = _port(
                lambda th, s, g: mpc_step(res, MPCState(theta=th, x=s), g,
                                          pm), tdt, theta0, start, goal)
            got = (p_state.theta, p_state.x, p_info["dist_to_goal"])
        else:
            xs, info = jax.jit(lambda s, g: jax_mpc_rollout(
                jtask.collision_residuals, s, g, jm, N_STEPS))(*ja[1:])
            ref = (xs, info["dist_to_goal"], info["final_state"].theta)
            p_xs, p_info = _port(lambda s, g: mpc_rollout(res, s, g, pm,
                                                          N_STEPS), tdt,
                                 start, goal)
            got = (p_xs, p_info["dist_to_goal"], p_info["final_state"].theta)
        ref = [np.asarray(r, np.float64) for r in ref]
    return ref, [g.double().numpy() for g in got]


@pytest.mark.parametrize("which", ["gpmp2_step", "mpc_step", "mpc_rollout"])
def test_matches_jax_in_float64(problem, which):
    ref, got = run_both(problem, which, np.float64)
    assert got[0].shape[-1] == 40 or which == "mpc_rollout"
    for r, g in zip(ref, got):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TOL_F64 * np.abs(r).max())


def test_float32_step_matches_jax_at_moderate_weights(problem):
    ref, got = run_both(problem, "mpc_step", np.float32,
                        dict(GP, sigma_coll=SIGMA_COLL_F32))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TOL_F32 * np.abs(r).max())


if __name__ == "__main__":
    jtask = jax_task(CONFIG4)
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    prob = (jtask, ptask) + _start_goal(ptask.robot)
    j64, p64 = run_both(prob, "mpc_step", np.float64)
    j32, p32 = run_both(prob, "mpc_step", np.float32)
    scale = float(np.abs(p64[0]).max())

    def gap(a, b):
        return float(np.abs(a - b).max()) / scale

    print(json.dumps({"B": B, "H": H, "rel_to_max_theta": {
        "jax64_vs_port64": gap(j64[0], p64[0]),
        "jax32_vs_port32": gap(j32[0], p32[0]),
        "port32_vs_port64": gap(p32[0], p64[0]),
        "jax32_vs_jax64": gap(j32[0], j64[0])}}))
