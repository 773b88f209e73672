"""The port's EE-pose goal factor (config 3's, benchmarks/run_all.py
config_panda) vs the JAX package on the same numpy inputs: the factor's
g, Hb and err, and the factor through the GN step, the reuse solve and the
MPC rollout, at a small size (the Panda in EnvSpheres3D, cutoff 0.03,
config 3's GPMP2Params at H = 16, B = 4, sigma_ee 1e-3, w_rot 0.2).

Tolerances.  The factor: float32 sums in another order, 2e-6 of max|g|
and of max|Hb| (lam = 1e6 scales both), 1e-6 on err.  The port computes
it on the lane FK chain, the reference on its array-of-structures chain:
poses agree to a few ulps (tests/test_torch_kin_jacobians.py).  The step
and the rollout: 1e-3 of max|theta|, tests/test_torch_mpc.py's bound; at
these weights (lam_coll 4e6, lam_ee 1e6) two correct float32 steps differ
by op order alone.  The reuse solve: 1e-4 of max|theta| against the same
schedule on JAX's systems, its costs (hinge sums weighted by 4e6) 1e-3
relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.kin import fk_all_links as jax_fk_all_links
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve import make_ee_goal_terms as jax_ee_terms
from torch_robotics_tpu.solve.gpmp2 import _lanes_gn_system as jax_gn_system
from torch_robotics_tpu.solve.gpmp2 import gpmp2_step as jax_gpmp2_step
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import mpc_rollout as jax_mpc_rollout
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.kin import fk_all_links
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                            gpmp2_solve, gpmp2_step,
                                            make_ee_goal_terms, mpc_rollout,
                                            straight_line_trajs)
from torch_robotics_tpu_torch.solve.btridiag_lanes import (
    solve_lanes_factor_core, solve_lanes_subst_core)
from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
from torch_robotics_tpu_torch.tasks import PlanningTask

B, H = 4, 16
# config 3's GPMP2Params (benchmarks/run_all.py:208-214) at H = 16
GP = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
          sigma_gp=1e-1, sigma_goal_prior=1e-2, sigma_coll=5e-4,
          step_size=0.8, sigma_gp_init=0.5)
EE = dict(sigma_ee=1e-3, w_rot=0.2)
TOL_TERMS, TOL_ERR, TOL, TOL_REUSE = 2e-6, 1e-6, 1e-3, 1e-4


@pytest.fixture(scope="module")
def problem():
    jrobot = JRobotPanda.create()
    probot = RobotPanda.create(device="cpu")
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=0.03)
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=probot,
                         obstacle_cutoff_margin=0.03)
    rng = np.random.default_rng(7)
    lo = probot.model.q_lower.astype(np.float64)
    hi = probot.model.q_upper.astype(np.float64)
    q_start = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=(B, 7))
    q_goal = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=7)
    start = np.concatenate([q_start, 0 * q_start], -1).astype(np.float32)
    goal = np.concatenate([q_goal, 0 * q_goal]).astype(np.float32)
    H_target = np.array(jax_fk_all_links(
        jrobot.model, jnp.asarray(goal[:7]), link_list=["ee_link"])[0])
    jterms = jax_ee_terms(jrobot, jnp.asarray(H_target), **EE)
    pterms = make_ee_goal_terms(probot, H_target, device="cpu", **EE)

    def jsystem(params):
        """JAX's GN system with the factor at ``params`` (jitted)."""
        return jax.jit(lambda th: jax_gn_system(
            jtask.collision_residuals.obstacle_terms_lanes, th,
            jnp.asarray(start), jnp.asarray(goal), params, jterms))

    return dict(jtask=jtask, ptask=ptask, start=start, goal=goal,
                H_target=H_target, jterms=jterms, pterms=pterms, rng=rng,
                lo=lo, hi=hi, jsystem=jsystem)


def _close(got, ref, tol, scale=None):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def test_target_is_the_port_fk_of_the_goal(problem):
    H_port = fk_all_links(RobotPanda.create(device="cpu").model,
                          torch.as_tensor(problem["goal"][:7]),
                          link_list=["ee_link"])[0]
    _close(H_port, problem["H_target"], 1e-6, scale=1.0)


def test_ee_terms_match_jax(problem):
    """8 random q (one past a joint's clamp, whose columns are masked),
    the goal q, and one q without a batch."""
    lo, hi = problem["lo"], problem["hi"]
    q = (lo + (hi - lo) * problem["rng"].uniform(size=(8, 7))).astype(
        np.float32)
    q[3, 2] = hi[2] + 0.1
    q = np.concatenate([q, problem["goal"][None, :7]])
    g_r, H_r, e_r = problem["jterms"](jnp.asarray(q))
    g, Hb, err = problem["pterms"](torch.as_tensor(q))
    _close(g, g_r, TOL_TERMS)
    _close(Hb, H_r, TOL_TERMS)
    _close(err, e_r, TOL_ERR, scale=1.0)
    # the masked column and its Hessian row are zero on both sides
    assert float(g[3, 2]) == 0.0 and float(Hb[3, 2].abs().max()) == 0.0
    # at the goal the residual vanishes
    assert float(err[-1]) < 1e-5
    for got, ref in zip(problem["pterms"](torch.as_tensor(q[0])),
                        problem["jterms"](jnp.asarray(q[0]))):
        assert got.shape == np.asarray(ref).shape
    # (B, H, d) batches keep their shape
    g3 = problem["pterms"](torch.as_tensor(q[:8].reshape(2, 4, 7)))[0]
    _close(g3.reshape(8, 14), g[:8].numpy(), TOL_TERMS)


def test_gn_system_and_step_with_ee_match_jax(problem):
    jtask, ptask = problem["jtask"], problem["ptask"]
    start, goal = problem["start"], problem["goal"]
    s_t, g_t = torch.as_tensor(start), torch.as_tensor(goal)
    gp, jgp = GPMP2Params(**GP), JGPMP2Params(**GP)
    theta = straight_line_trajs(s_t, g_t, H)
    ref = problem["jsystem"](jgp)(jnp.asarray(theta.numpy()))
    got = _lanes_gn_system(ptask.collision_residuals.obstacle_terms_lanes,
                           theta, s_t, g_t, gp, problem["pterms"])
    assert got[1].is_contiguous() and got[0].is_contiguous()
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r, 1e-5)
    # the factor sits on the last block only
    plain = _lanes_gn_system(ptask.collision_residuals.obstacle_terms_lanes,
                             theta, s_t, g_t, gp)
    assert torch.equal(plain[1][:-1], got[1][:-1])
    assert not torch.equal(plain[1][-1], got[1][-1])

    j_theta, j_cost = jax.jit(lambda th, s, g: jax_gpmp2_step(
        jtask.collision_residuals, th, s, g, jgp, problem["jterms"]))(
        jnp.asarray(theta.numpy()), jnp.asarray(start), jnp.asarray(goal))
    p_theta, p_cost = gpmp2_step(ptask.collision_residuals, theta, s_t, g_t,
                                 gp, problem["pterms"])
    _close(p_theta, j_theta, TOL)
    np.testing.assert_allclose(p_cost.numpy(), np.asarray(j_cost), rtol=TOL)


def test_reuse_solve_with_ee(problem):
    """refactor_every = 2 on the CPU: the substitution iterations re-solve
    against the factor of their refactor iteration, whose last block held
    that iteration's EE Hessian.  The reference schedule here: JAX's GN
    system (with the factor) each iteration, solved by the plain factor /
    substitution sweeps (held to JAX's kernels in interpret mode by
    tests/test_torch_btridiag_reuse.py; JAX's m = 14 factor kernel takes
    minutes to interpret).  At moderate weights (sigma_coll 1e-3, step
    0.5): at config 3's, stale factors make the schedule chaotic, as the
    reference documents for production weights."""
    jtask, ptask = problem["jtask"], problem["ptask"]
    start, goal = problem["start"], problem["goal"]
    p = GPMP2Params(**dict(GP, opt_iters=6, sigma_coll=1e-3, step_size=0.5,
                           refactor_every=2))
    system = problem["jsystem"](JGPMP2Params(**dataclasses.asdict(p)))
    s_t, g_t = torch.as_tensor(start), torch.as_tensor(goal)
    theta0 = straight_line_trajs(s_t, g_t, H)
    got = gpmp2_solve(ptask.collision_residuals, theta0, s_t, g_t, p,
                      problem["pterms"])

    theta, costs = theta0, []
    for it in range(p.opt_iters):
        b_l, D_l, U_l, cost = (torch.tensor(np.asarray(a)) for a in
                               system(jnp.asarray(theta.numpy())))
        if it % p.refactor_every == 0:
            x, L, W = solve_lanes_factor_core(D_l, U_l, b_l)
        else:
            x = solve_lanes_subst_core(L, W, b_l)
        theta = theta + p.step_size * x.permute(2, 0, 1)
        costs.append(cost)
    _close(got.trajs, theta.numpy(), TOL_REUSE)
    np.testing.assert_allclose(got.cost_trace.numpy(),
                               torch.stack(costs).numpy(), rtol=TOL)
    # the schedule took the substitution, and the factor moved the result
    every = gpmp2_solve(ptask.collision_residuals, theta0, s_t, g_t,
                        dataclasses.replace(p, refactor_every=1),
                        problem["pterms"])
    no_ee = gpmp2_solve(ptask.collision_residuals, theta0, s_t, g_t, p)
    assert not torch.equal(got.trajs, every.trajs)
    assert not torch.equal(got.trajs, no_ee.trajs)


def test_mpc_rollout_with_ee_matches_jax(problem):
    jtask, ptask = problem["jtask"], problem["ptask"]
    start, goal = problem["start"], problem["goal"]
    mp = MPCParams(gpmp2=GPMP2Params(**GP), iters_per_step=2)
    jmp = JMPCParams(gpmp2=JGPMP2Params(**GP), iters_per_step=2)
    j_xs, j_info = jax_mpc_rollout(
        jtask.collision_residuals, jnp.asarray(start), jnp.asarray(goal),
        jmp, 3, ee_goal_terms=problem["jterms"])
    p_xs, p_info = mpc_rollout(
        ptask.collision_residuals, torch.as_tensor(start),
        torch.as_tensor(goal), mp, 3, ee_goal_terms=problem["pterms"])
    _close(p_xs, j_xs, TOL)
    _close(p_info["final_state"].theta, j_info["final_state"].theta, TOL)
    np.testing.assert_allclose(p_info["dist_to_goal"].numpy(),
                               np.asarray(j_info["dist_to_goal"]), rtol=TOL)
