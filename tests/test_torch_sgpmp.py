"""The port's sGPMP (``solve/sampling.py``) vs the JAX package's
``sgpmp_solve`` on the same normals: JAX's own draws, computed here from its
key splits and handed to ``sgpmp_solve_normals``.

- Panda in EnvSpheres3D (cutoff 0.06, as the sGPMP bench), 2 problems x 2
  particles, H = 8, K = 4, 3 iterations at the bench's weights
  (sigma_coll 1e-5): candidates are scored through the value-only cost
  hook in both packages.  In float64 the two compute the same function, so
  trajectories and the cost trace are held to 1e-8 relative (the softmax
  weights of costs ~1e10 amplify float32 rounding past any useful float32
  tolerance at these weights).
- A two-arm MultiRobot (Panda and UR10 of tests/test_pallas_terms.py)
  through its new cost hook at a moderate collision weight (sigma_coll
  1e-2): in float64 as the Panda, and in float32 each package held to the
  float64 run (the port no worse than twice the JAX package's error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multi_robot import (TWO_ARM, export_jax_multirobot_task,
                                    jax_task)
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve.sampling import SGPMPParams as JSGPMPParams
from torch_robotics_tpu.solve.sampling import sgpmp_solve as jax_sgpmp_solve
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import (SGPMPParams, sgpmp_solve,
                                            sgpmp_solve_normals,
                                            straight_line_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask

H, K, ITERS, N_PROB, N_PART = 8, 4, 3, 2, 2
SP = dict(n_support_points=H, dt=0.04, opt_iters=ITERS, num_samples=K,
          sigma_coll=1e-5, temperature=1.0, sigma_gp_sample=0.2)


def _problem(lo, hi, seed):
    """start, goal (n, 2d) inside the joint box and theta0 (n, H, 2d): the
    straight line plus smooth noise, one row per particle."""
    rng = np.random.default_rng(seed)
    d = lo.shape[0]
    n = N_PROB * N_PART
    q0 = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=(N_PROB, d))
    q1 = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=(N_PROB, d))
    z = np.zeros_like(q0)
    start = np.repeat(np.concatenate([q0, z], -1), N_PART, axis=0)
    goal = np.repeat(np.concatenate([q1, z], -1), N_PART, axis=0)
    line = straight_line_trajs(torch.as_tensor(start), torch.as_tensor(goal),
                               H, dt=0.04).numpy()
    bump = np.sin(np.linspace(0, np.pi, H))[None, :, None]
    noise = 0.2 * rng.normal(size=(n, 1, 2 * d)) * bump
    noise[..., d:] = 0.0
    return start, goal, line + noise


def _run_both(jtask, ptask, start, goal, theta0, params, dtype):
    """JAX's sgpmp_solve and the port's sgpmp_solve_normals on JAX's own
    normals -> ((trajs, cost_trace) jax, (trajs, cost_trace) port), float64
    numpy."""
    key = jax.random.PRNGKey(1)
    shape = (params["num_samples"],) + theta0.shape[:-2] + (
        theta0.shape[-2] * theta0.shape[-1],)
    with jax.enable_x64(dtype == np.float64):
        keys = jax.random.split(key, params["opt_iters"])
        xi = np.stack([np.asarray(jax.random.normal(k, shape, dtype))
                       for k in keys])
        res = jax.jit(lambda th, s, g: jax_sgpmp_solve(
            jtask.collision_residuals, th, s, g, JSGPMPParams(**params),
            key=key))(*(jnp.asarray(a, dtype) for a in (theta0, start,
                                                       goal)))
        j = (np.asarray(res.trajs, np.float64),
             np.asarray(res.cost_trace, np.float64))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    out = sgpmp_solve_normals(
        ptask.collision_residuals,
        *(torch.as_tensor(a, dtype=tdt) for a in (theta0, start, goal)),
        SGPMPParams(**params), torch.as_tensor(xi))
    return j, (out.trajs.double().numpy(), out.cost_trace.double().numpy())


def test_panda_sgpmp_matches_jax_in_float64():
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.06)
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.06)
    assert ptask.collision_residuals.collision_cost_lanes is not None
    model = ptask.robot.model
    start, goal, theta0 = _problem(model.q_lower, model.q_upper, seed=0)
    (jt, jc), (pt, pc) = _run_both(jtask, ptask, start, goal, theta0, SP,
                                   np.float64)
    assert pt.shape == (N_PROB * N_PART, H, 14) and pc.shape == (
        ITERS, N_PROB * N_PART)
    assert np.isfinite(pt).all() and np.isfinite(pc).all()
    # the solve moved the means: some step was accepted
    assert np.abs(pt - theta0).max() > 1e-6
    np.testing.assert_allclose(pt, jt, rtol=0, atol=1e-8 * np.abs(jt).max())
    np.testing.assert_allclose(pc, jc, rtol=1e-8)


def test_two_arm_multirobot_sgpmp_matches_jax():
    """In float64 to 1e-8 as the Panda; in float32 each package is held to
    the float64 run, the port no worse than twice the JAX package's own
    float32 error (+1e-5): the softmax weights amplify float32 rounding to
    ~4e-3 of max|theta| in both packages after 3 iterations."""
    jtask = jax_task(TWO_ARM)
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    assert ptask.collision_residuals.collision_cost_lanes is not None
    lo = ptask.robot.q_min.numpy()
    hi = ptask.robot.q_max.numpy()
    start, goal, theta0 = _problem(lo, hi, seed=1)
    params = dict(SP, sigma_coll=1e-2)
    (jt, jc), (pt, pc) = _run_both(jtask, ptask, start, goal, theta0, params,
                                   np.float64)
    assert np.abs(pt - theta0).max() > 1e-4
    scale = np.abs(jt).max()
    np.testing.assert_allclose(pt, jt, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(pc, jc, rtol=1e-8)
    (jt32, jc32), (pt32, pc32) = _run_both(jtask, ptask, start, goal, theta0,
                                           params, np.float32)
    assert np.isfinite(pt32).all() and np.isfinite(pc32).all()
    err_p = np.abs(pt32 - pt).max() / scale
    err_j = np.abs(jt32 - pt).max() / scale
    assert err_p <= 2.0 * err_j + 1e-5, (err_p, err_j)
    cerr_p = np.abs(pc32 / pc - 1).max()
    cerr_j = np.abs(jc32 / pc - 1).max()
    assert cerr_p <= 2.0 * cerr_j + 1e-6, (cerr_p, cerr_j)


def test_sgpmp_solve_draws_from_its_generator():
    """sgpmp_solve draws each iteration's normals from the generator in
    order: the same seed gives sgpmp_solve_normals' result on those
    draws."""
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.06)
    model = ptask.robot.model
    start, goal, theta0 = (torch.as_tensor(a, dtype=torch.float32) for a in
                           _problem(model.q_lower, model.q_upper, seed=2))
    p = SGPMPParams(**dict(SP, opt_iters=2))
    res = sgpmp_solve(ptask.collision_residuals, theta0, start, goal, p,
                      generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    xi = torch.stack([torch.randn((K,) + theta0.shape[:-2] + (H * 14,),
                                  generator=gen) for _ in range(2)])
    ref = sgpmp_solve_normals(ptask.collision_residuals, theta0, start, goal,
                              p, xi)
    assert torch.equal(res.trajs, ref.trajs)
    assert torch.equal(res.cost_trace, ref.cost_trace)


def test_from_preset_casts_counts():
    p = SGPMPParams.from_preset({"n_support_points": 16.0, "opt_iters": 5.0,
                                 "num_samples": 8.0, "temperature": 0.5,
                                 "unknown": 1})
    assert (p.n_support_points, p.opt_iters, p.num_samples) == (16, 5, 8)
    assert p.temperature == 0.5
    assert p == SGPMPParams(**{k: getattr(JSGPMPParams.from_preset(
        {"n_support_points": 16.0, "opt_iters": 5.0, "num_samples": 8.0,
         "temperature": 0.5}), k) for k in SGPMPParams.__dataclass_fields__})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gp_energy_matches_jax(dtype):
    from torch_robotics_tpu.solve.sampling import _gp_energy as jax_energy
    from torch_robotics_tpu_torch.solve.sampling import _gp_energy
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(3, 2, 6, 8))
    s, g = rng.normal(size=(2, 8)), rng.normal(size=(2, 8))
    p = dict(n_support_points=6, dt=0.05, sigma_gp=0.1, sigma_start=1e-2,
             sigma_goal_prior=1e-2)
    f64 = dtype == torch.float64
    with jax.enable_x64(f64):
        npdt = np.float64 if f64 else np.float32
        ref = np.asarray(jax_energy(*(jnp.asarray(a, npdt)
                                      for a in (theta, s, g)),
                                    JSGPMPParams(**p)))
    got = _gp_energy(*(torch.as_tensor(a, dtype=dtype) for a in (theta, s, g)),
                     SGPMPParams(**p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12 if f64 else 1e-5)
