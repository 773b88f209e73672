"""The port's batch GPMP2 solvers on the point mass in the 2-D dense scene
(config 2's task) vs the JAX package on the same numpy inputs: the exact GP
prior sampler, the fixed-count solve, the adaptive solve and the restart
policy, and the presets.

The sampler's normals come from numpy and go to both packages (the port
draws from a torch.Generator where the reference splits a key).  Host-side
float64 matrices agree to 1e-10; trajectories from the same normals in
float32 to 1e-6 of their max.  The solve is held to JAX in float64 (1e-8
of max|theta|) at the config's own weights, and in float32 at the MPC
tests' 1e-3 of max|theta| at moderate weights (tests/test_solve_gpmp2.py's
reuse setup): at the preset's weights (1/sigma^2 = 1e10) two correct
float32 solves differ by far more than that from op order alone."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import make_env as jmake_env
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve import gp_prior as jgp
from torch_robotics_tpu.solve.gpmp2 import gpmp2_solve as jax_gpmp2_solve
from torch_robotics_tpu.solve.gpmp2 import \
    gpmp2_solve_adaptive as jax_gpmp2_solve_adaptive
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu.utils.files import get_data_path
from torch_robotics_tpu_torch.envs import EnvDense2D, make_env
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import (GPMP2Params, gpmp2_init_trajs,
                                            gpmp2_solve,
                                            gpmp2_solve_adaptive,
                                            gpmp2_solve_restarts,
                                            sample_gp_prior_trajs)
from torch_robotics_tpu_torch.solve import gp_prior
from torch_robotics_tpu_torch.tasks import PlanningTask

CUTOFF = 0.02
START = np.asarray([-0.9, -0.9, 0.0, 0.0])
GOAL = np.asarray([0.9, 0.9, 0.0, 0.0])
# tests/test_solve_gpmp2.py's reuse setup (moderate weights)
MODERATE = dict(n_support_points=8, dt=0.1, opt_iters=6, sigma_start=1e-3,
                sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-3,
                step_size=0.5)
TOL_F64, TOL_F32 = 1e-8, 1e-3


@pytest.fixture(scope="module")
def tasks():
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=CUTOFF)
    ptask = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=CUTOFF)
    return jtask, ptask


def _preset(ptask, **kw):
    p = GPMP2Params.from_preset(ptask.env.get_gpmp2_params(ptask.robot))
    return dataclasses.replace(p, **kw)


def _theta0(B, H, sigma, seed, dt=0.04, start=START, goal=GOAL):
    """Prior samples from numpy normals, float64 numpy (B, H, 4)."""
    xi = np.random.default_rng(seed).normal(size=(B, H * 4))
    return gp_prior.gp_prior_trajs_from_normals(
        torch.as_tensor(xi), torch.as_tensor(start), torch.as_tensor(goal),
        H, dt, sigma).numpy()


@pytest.mark.parametrize("H,dt,sigma", [(64, 0.04, 0.2), (8, 0.1, 0.5)])
def test_sampler_matrices_match_jax(H, dt, sigma):
    with jax.enable_x64(True):
        jW = jgp.gp_bridge_mean_matrices(2, H, dt, sigma, dtype=jnp.float64)
        jM = jgp.gp_bridge_sampler_matrix(2, H, dt, sigma, dtype=jnp.float64)
        jmu = jgp.gp_bridge_mean(jnp.asarray(START), jnp.asarray(GOAL), H, dt,
                                 sigma)
    W = gp_prior.gp_bridge_mean_matrices(2, H, dt, sigma,
                                         dtype=torch.float64, device="cpu")
    M = gp_prior.gp_bridge_sampler_matrix(2, H, dt, sigma,
                                          dtype=torch.float64, device="cpu")
    mu = gp_prior.gp_bridge_mean(torch.as_tensor(START),
                                 torch.as_tensor(GOAL), H, dt, sigma)
    for got, ref in ((W[0], jW[0]), (W[1], jW[1]), (M, jM), (mu, jmu)):
        ref = np.asarray(ref)
        assert got.dtype == torch.float64 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-10 * np.abs(ref).max())


def test_trajectories_from_the_same_normals_match_jax():
    """mean + xi M^T in float32, batched endpoints (one sample each)."""
    H, B = 64, 12
    rng = np.random.default_rng(3)
    xi = rng.normal(size=(B, H * 4)).astype(np.float32)
    start = np.tile(START, (B, 1)).astype(np.float32)
    goal = (np.tile(GOAL, (B, 1))
            + rng.uniform(-0.1, 0.1, size=(B, 4))).astype(np.float32)
    M = jgp.gp_bridge_sampler_matrix(2, H, 0.04, 0.2)
    ref = np.asarray(jgp.gp_bridge_mean(jnp.asarray(start), jnp.asarray(goal),
                                        H, 0.04, 0.2)
                     + (jnp.asarray(xi) @ M.T).reshape(B, H, 4))
    got = gp_prior.gp_prior_trajs_from_normals(
        torch.as_tensor(xi), torch.as_tensor(start), torch.as_tensor(goal), H,
        0.04, 0.2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max())


def test_sampler_draws_its_normals_from_the_generator():
    """sample_gp_prior_trajs is the map above applied to the generator's
    standard normals; gpmp2_init_trajs samples num_samples of them."""
    H, n = 16, 5
    s, g = torch.as_tensor(START, dtype=torch.float32), torch.as_tensor(
        GOAL, dtype=torch.float32)
    got = sample_gp_prior_trajs(torch.Generator().manual_seed(4), s, g, H, n,
                                0.04, 0.2)
    xi = torch.randn((n, H * 4), generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, gp_prior.gp_prior_trajs_from_normals(
        xi, s, g, H, 0.04, 0.2))
    p = GPMP2Params(n_support_points=H, num_samples=n)
    assert torch.equal(gpmp2_init_trajs(torch.Generator().manual_seed(4), p,
                                        s, g), got)


def _jax_solve(jtask, theta0, params, dtype, adaptive=False):
    f64 = dtype == np.float64
    with jax.enable_x64(f64):
        args = (jtask.collision_residuals, jnp.asarray(theta0, dtype),
                jnp.asarray(START, dtype), jnp.asarray(GOAL, dtype),
                JGPMP2Params(**dataclasses.asdict(params)))
        if adaptive:
            trajs, costs, n = jax_gpmp2_solve_adaptive(*args)
            return np.asarray(trajs, np.float64), int(n)
        res = jax_gpmp2_solve(*args)
        return (np.asarray(res.trajs, np.float64),
                np.asarray(res.cost_trace, np.float64))


def _port_solve(ptask, theta0, params, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return gpmp2_solve(ptask.collision_residuals,
                       torch.as_tensor(theta0, dtype=tdt),
                       torch.as_tensor(START, dtype=tdt),
                       torch.as_tensor(GOAL, dtype=tdt), params)


def test_solve_matches_jax_in_float64_at_the_preset_weights(tasks):
    """B = 16, H = 8, 6 iterations at config 2's weights."""
    jtask, ptask = tasks
    p = _preset(ptask, n_support_points=8, opt_iters=6, num_samples=16)
    theta0 = _theta0(16, 8, 0.5, seed=5)
    j_trajs, j_trace = _jax_solve(jtask, theta0, p, np.float64)
    res = _port_solve(ptask, theta0, p, np.float64)
    assert res.trajs.shape == (16, 8, 4) and res.cost_trace.shape == (6, 16)
    np.testing.assert_allclose(res.trajs.numpy(), j_trajs,
                               atol=TOL_F64 * np.abs(j_trajs).max())
    np.testing.assert_allclose(res.cost_trace.numpy(), j_trace, rtol=1e-6,
                               atol=1e-6 * np.abs(j_trace).max())
    assert torch.equal(res.costs, res.cost_trace[-1])
    assert float(res.cost_trace[0].max()) > 0          # the scene is active


def test_solve_matches_jax_in_float32(tasks):
    jtask, ptask = tasks
    p = GPMP2Params(**MODERATE)
    theta0 = _theta0(16, 8, 0.5, seed=6, dt=0.1).astype(np.float32)
    j_trajs, j_trace = _jax_solve(jtask, theta0, p, np.float32)
    res = _port_solve(ptask, theta0, p, np.float32)
    np.testing.assert_allclose(res.trajs.numpy(), j_trajs,
                               atol=TOL_F32 * np.abs(j_trajs).max())
    np.testing.assert_allclose(res.cost_trace.numpy(), j_trace, rtol=TOL_F32,
                               atol=TOL_F32 * np.abs(j_trace).max())


def test_adaptive_solve(tasks):
    """stop_criteria = 0 is the fixed-count solve bit for bit; a positive
    criterion stops where JAX's while loop stops (float64)."""
    jtask, ptask = tasks
    theta0 = _theta0(8, 16, 1e-3, seed=7)
    p0 = _preset(ptask, n_support_points=16, opt_iters=5)
    tdt = torch.float64
    args = (ptask.collision_residuals, torch.as_tensor(theta0, dtype=tdt),
            torch.as_tensor(START, dtype=tdt),
            torch.as_tensor(GOAL, dtype=tdt))
    trajs, costs, n = gpmp2_solve_adaptive(*args, p0)
    fixed = gpmp2_solve(*args, p0)
    assert n == 5 and torch.equal(trajs, fixed.trajs)
    assert torch.equal(costs, fixed.costs)
    p = _preset(ptask, n_support_points=16, opt_iters=60, stop_criteria=1e-3)
    trajs, costs, n = gpmp2_solve_adaptive(*args, p)
    j_trajs, j_n = _jax_solve(jtask, theta0, p, np.float64, adaptive=True)
    assert 2 <= n < 60 and n == j_n
    np.testing.assert_allclose(trajs.numpy(), j_trajs,
                               atol=TOL_F64 * np.abs(j_trajs).max())


def test_restarts_keep_free_lanes_and_do_not_lower_the_free_fraction(tasks):
    _, ptask = tasks
    p = _preset(ptask, opt_iters=40, num_samples=16, sigma_gp_init=0.5)
    s, g = (torch.as_tensor(a, dtype=torch.float32) for a in (START, GOAL))
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(8), p, s, g)

    def free_fn(trajs):
        return ~ptask.trajs_collision_masks(trajs)[0]

    base = gpmp2_solve(ptask.collision_residuals, theta0, s, g, p)
    res = gpmp2_solve_restarts(ptask.collision_residuals, theta0, s, g, p,
                               free_fn, torch.Generator().manual_seed(9),
                               restart_rounds=2, restart_iters=10)
    free0 = free_fn(base.trajs)
    assert 0 < int(free0.sum()) < 16
    assert torch.equal(res.trajs[free0], base.trajs[free0])
    assert torch.equal(res.costs[free0], base.costs[free0])
    assert torch.equal(res.cost_trace, base.cost_trace)
    assert bool(torch.isfinite(res.trajs).all())
    assert float(free_fn(res.trajs).float().mean()) >= float(
        free0.float().mean())


def test_params_fields_and_presets_match_jax():
    assert ([f.name for f in dataclasses.fields(GPMP2Params)]
            == [f.name for f in dataclasses.fields(JGPMP2Params)])
    assert dataclasses.asdict(GPMP2Params()) == dataclasses.asdict(
        JGPMP2Params())
    layouts = json.loads((get_data_path() / "env_layouts.json").read_text())
    names = [k for k, v in layouts.items()
             if v["planner_params"].get("gpmp2") is not None]
    assert "EnvDense2D" in names and len(names) >= 10
    for name in names:
        got = GPMP2Params.from_preset(
            make_env(name, device="cpu").get_gpmp2_params())
        ref = JGPMP2Params.from_preset(jmake_env(name).get_gpmp2_params())
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), name
    with pytest.raises(NotImplementedError):
        make_env("EnvSpheres3D", device="cpu").get_gpmp2_params(
            RobotPointMass.create(device="cpu"))
