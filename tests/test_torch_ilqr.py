"""The port's iLQR path vs the JAX package on the same numpy inputs: the
planning task's residuals and Jacobians, its collision checks and metrics,
and ``ilqr_solve`` (batch and tracking calls) at a small size of the
iLQR bench workload (Panda in EnvSpheres3D, cutoff 0.06,
benchmarks/ilqr_sgpmp_bench.py).

Tolerances:
- residuals, Jacobians, FK points: float32 op order, 1e-5 of max|ref| +
  1e-5 relative; random q meets no workspace-face or SDF ties (JAX
  differentiates jnp.min there, the port takes the first minimal face);
- ilqr_solve in float64: 1e-8 relative (op order only; the line search's
  argmin over 5 step sizes is the same in both);
- ilqr_solve in float32 at moderate weights: 1e-4 of max|x|.  At the bench
  weights (kg / r = 4e10) two float32 runs may pick different step sizes
  after a last-bit difference, so float32 is held at weights where the
  argmin is stable and float64 at the bench weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.solve.ilqr import ILQRParams as JILQRParams
from torch_robotics_tpu.solve.ilqr import ilqr_solve as jax_ilqr_solve
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve
from torch_robotics_tpu_torch.tasks import PlanningTask

B, H, ITERS = 8, 16, 5
# the bench's iLQR weights (benchmarks/ilqr_sgpmp_bench.py:106-108)
BENCH = dict(n_support_points=H, dt=0.04, opt_iters=ITERS, sigma_coll=2e-3,
             sigma_goal_prior=5e-3, sigma_limits=5e-3, r_control=1e-6)
MODERATE = dict(BENCH, sigma_coll=0.1, sigma_goal_prior=0.1, r_control=1e-2)
TOL_ROWS, TOL_F64, TOL_F32 = 1e-5, 1e-8, 1e-4


def _make_tasks(dtype=np.float32):
    with jax.enable_x64(dtype == np.float64):
        jtask = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                              obstacle_cutoff_margin=0.06)
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.06)
    return jtask, ptask


@pytest.fixture(scope="module")
def tasks():
    return _make_tasks()


def _rand_q(n, seed, spread=1.0):
    """q (n, 7) uniform over ``spread`` times the joint range."""
    model = RobotPanda.create(device="cpu").model
    lo, hi = model.q_lower.astype(np.float64), model.q_upper.astype(np.float64)
    u = np.random.default_rng(seed).uniform(0.5 - spread / 2,
                                            0.5 + spread / 2, size=(n, 7))
    return (lo + u * (hi - lo)).astype(np.float32)


@pytest.fixture(scope="module")
def problem(tasks):
    """The bench's draw from a numpy seed: collision-free starts, goals the
    first free of 16 perturbations of the start (clipped 0.01 inside the
    joint limits), zero velocities."""
    _, ptask = tasks
    lo = ptask.robot.q_min.numpy()
    hi = ptask.robot.q_max.numpy()
    cand = _rand_q(64 * B, seed=0)
    free = ~ptask.compute_collision(torch.as_tensor(cand)).numpy()
    qs = cand[free][:B]
    rng = np.random.default_rng(1)
    pert = np.clip(qs + 0.6 * rng.normal(size=(16, B, 7)), lo + 0.01,
                   hi - 0.01).astype(np.float32)
    pfree = ~ptask.compute_collision(
        torch.as_tensor(pert.reshape(-1, 7))).numpy().reshape(16, B)
    idx = np.argmax(pfree, axis=0)
    qg = np.where(pfree.any(0)[:, None], pert[idx, np.arange(B)], qs)
    z = np.zeros_like(qs)
    return (np.concatenate([qs, z], -1), np.concatenate([qg, z], -1))


def _assert_rows(got, ref, name):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), ref, rtol=TOL_ROWS,
        atol=TOL_ROWS * float(np.abs(ref).max()), err_msg=name)


def test_fk_map_collision_with_jac_matches_jax(tasks):
    jtask, ptask = tasks
    q = _rand_q(32, seed=2, spread=1.4)          # some joints past clamps
    pts_j, J_j = jtask.robot.fk_map_collision_with_jac(jnp.asarray(q))
    pts, J = ptask.robot.fk_map_collision_with_jac(torch.as_tensor(q))
    assert J.shape == J_j.shape == (32, ptask.robot.model.n_links, 3, 7)
    _assert_rows(pts.numpy(), pts_j, "points")
    _assert_rows(J.numpy(), J_j, "J")


def test_residuals_and_jacobian_match_jax(tasks):
    """Rows in the same order (objects, workspace bounds, self pairs), on a
    batch with leading dims (4, 8) and rows of every kind active."""
    jtask, ptask = tasks
    q = _rand_q(32, seed=3, spread=1.2).reshape(4, 8, 7)
    jres = jtask.collision_residuals
    pres = ptask.collision_residuals
    assert pres.supports_batch and pres.residuals_and_jacobian.supports_batch
    r_j, J_j = jres.residuals_and_jacobian(jnp.asarray(q))
    r, J = pres.residuals_and_jacobian(torch.as_tensor(q))
    assert r.shape == r_j.shape and J.shape == J_j.shape
    assert float(np.asarray(r_j).max()) > 0
    _assert_rows(r.numpy(), r_j, "r")
    _assert_rows(J.numpy(), J_j, "J")
    _assert_rows(pres(torch.as_tensor(q)).numpy(), jres(jnp.asarray(q)),
                 "residuals")


@pytest.mark.parametrize("margin", [None, 0.0])
def test_compute_collision_matches_jax(tasks, margin):
    jtask, ptask = tasks
    q = _rand_q(256, seed=4, spread=1.2)
    x = np.concatenate([q, np.zeros_like(q)], -1)
    got = ptask.compute_collision(torch.as_tensor(x), margin=margin)
    ref = np.asarray(jtask.compute_collision(jnp.asarray(x), margin=margin))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < 256
    np.testing.assert_array_equal(got.numpy(), ref)


def test_trajectory_metrics_match_jax(tasks, problem):
    """Per-trajectory flags, per-waypoint flags and fraction free on the
    straight lines from the free starts to their goals, the starts held
    still (free), and noisy copies that leave the joint limits."""
    jtask, ptask = tasks
    start, goal = (a[:, :7] for a in problem)
    s = np.linspace(0.0, 1.0, 8)[None, :, None]
    lines = start[:, None] * (1 - s) + goal[:, None] * s
    still = np.repeat(start[:, None], 8, axis=1)
    noisy = lines + 0.5 * np.random.default_rng(5).normal(size=lines.shape)
    trajs = np.concatenate([lines, still, noisy]).astype(np.float32)
    mask, wp = ptask.trajs_collision_masks(torch.as_tensor(trajs))
    mask_j, wp_j = jtask.trajs_collision_masks(jnp.asarray(trajs))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wp_j))
    frac = ptask.compute_fraction_free_trajs(torch.as_tensor(trajs))
    assert frac == jtask.compute_fraction_free_trajs(jnp.asarray(trajs))
    assert 0.0 < frac < 1.0 and not bool(mask[B:2 * B].any())


def test_random_coll_free_q(tasks):
    _, ptask = tasks
    g = torch.Generator().manual_seed(0)
    qs, n = ptask.random_coll_free_q(g, n_samples=16, max_samples=1024)
    assert n == 16 and qs.shape == (16, 7)
    assert not bool(ptask.compute_collision(qs).any())
    assert bool(((qs >= ptask.robot.q_min) & (qs <= ptask.robot.q_max)).all())
    q1, n1 = ptask.random_coll_free_q(torch.Generator().manual_seed(0),
                                      max_samples=1024)
    assert n1 == 1 and torch.equal(q1, qs[0])


def _solve_both(dtype, params, start, goal, **kw):
    """The same solve through both packages in ``dtype`` -> (jax, port)
    results as float64 numpy (trajs, controls, costs, cost_trace)."""
    f64 = dtype == np.float64
    jtask, ptask = _make_tasks(dtype)
    with jax.enable_x64(f64):
        jkw = {k: jnp.asarray(v, dtype) for k, v in kw.items()}
        jres = jax_ilqr_solve(
            jtask.collision_residuals, jnp.asarray(start, dtype),
            jnp.asarray(goal, dtype), JILQRParams(riccati="pallas", **params),
            q_limits=(jtask.robot.q_min, jtask.robot.q_max), **jkw)
        jout = [np.asarray(a, np.float64) for a in jres]
    tdt = torch.float64 if f64 else torch.float32
    pres = ilqr_solve(
        ptask.collision_residuals, torch.as_tensor(start, dtype=tdt),
        torch.as_tensor(goal, dtype=tdt), ILQRParams(**params),
        q_limits=(ptask.robot.q_min, ptask.robot.q_max),
        **{k: torch.as_tensor(v, dtype=tdt) for k, v in kw.items()})
    assert all(a.dtype == tdt for a in pres)
    return jout, [a.double().numpy() for a in pres]


def _assert_solves(jout, pout, tol, rel_to_max):
    for name, r, g in zip(("trajs", "controls", "costs", "cost_trace"),
                          jout, pout):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        if rel_to_max:      # float32: relative to max|x| of the trajectory
            np.testing.assert_allclose(
                g, r, rtol=0, atol=tol * float(np.abs(jout[0]).max())
                if name == "trajs" else tol * float(np.abs(r).max()),
                err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=tol,
                                       atol=tol * float(np.abs(r).max()),
                                       err_msg=name)


def test_ilqr_solve_matches_jax_float64(problem):
    start, goal = problem
    jout, pout = _solve_both(np.float64, BENCH, start, goal)
    _assert_solves(jout, pout, TOL_F64, rel_to_max=False)
    # a step is taken only where it lowers the cost
    assert (np.diff(pout[3], axis=0) <= 0).all()


def test_ilqr_solve_matches_jax_float32_moderate_weights(problem):
    start, goal = problem
    jout, pout = _solve_both(np.float32, MODERATE, start, goal)
    _assert_solves(jout, pout, TOL_F32, rel_to_max=True)


def test_ilqr_tracking_call_matches_jax(problem):
    """One tracking-MPC call: warm-start controls, a reference window and a
    running goal pull (the bench's MPC loop, benchmarks/ilqr_sgpmp_bench.py
    :156-176), in float64."""
    start, goal = problem
    H_trk = 8
    s = np.linspace(0.0, 1.0, H_trk)[None, :, None]
    q_ref = start[:, None, :7] * (1 - s) + goal[:, None, :7] * s
    v_ref = np.repeat(((goal - start)[:, None, :7]) / (H_trk * 0.04),
                      H_trk, axis=1)
    x_ref = np.concatenate([q_ref, v_ref], -1)
    u_init = 0.1 * np.random.default_rng(8).normal(size=(B, H_trk - 1, 7))
    params = dict(BENCH, n_support_points=H_trk, opt_iters=3,
                  sigma_goal_running=0.05, r_control=1e-3)
    jout, pout = _solve_both(np.float64, params, start, goal,
                             u_init=u_init, x_ref=x_ref)
    _assert_solves(jout, pout, TOL_F64, rel_to_max=False)


def test_trajectories_obey_the_double_integrator(problem, tasks):
    """Every mode gives dynamically feasible states, the kernel mode takes
    the plain sweeps on CPU tensors bit for bit, and the QR form agrees
    with them (float64)."""
    _, ptask = tasks
    start, goal = (torch.as_tensor(a, dtype=torch.float64) for a in problem)
    out = {}
    for mode in ("kernel", "lanes", "qr"):
        out[mode] = ilqr_solve(ptask.collision_residuals, start, goal,
                               ILQRParams(riccati=mode, **BENCH),
                               q_limits=(ptask.robot.q_min,
                                         ptask.robot.q_max))
    for a, b in zip(out["kernel"], out["lanes"]):
        assert torch.equal(a, b)
    for a, b in zip(out["qr"], out["lanes"]):
        torch.testing.assert_close(a, b, rtol=1e-7,
                                   atol=1e-7 * float(b.abs().max()))
    x, u, dt = out["kernel"].trajs, out["kernel"].controls, BENCH["dt"]
    q, v = x[..., :7], x[..., 7:]
    err_q = (x[:, 1:, :7] - (q[:, :-1] + dt * v[:, :-1] + 0.5 * dt * dt * u))
    err_v = x[:, 1:, 7:] - (v[:, :-1] + dt * u)
    assert float(err_q.abs().max()) < 1e-12 and float(err_v.abs().max()) < 1e-12
    with pytest.raises(ValueError):
        ilqr_solve(ptask.collision_residuals, start, goal,
                   ILQRParams(riccati="pallas", **BENCH))


if __name__ == "__main__":
    # float32 vs float64 gaps of one iteration and of a 5-iteration solve at
    # the bench weights, in both packages, relative to max|x| (one JSON
    # line):  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ilqr.py
    import json

    start, goal = problem.__wrapped__(_make_tasks())
    out = {}
    for iters in (1, ITERS):
        params = dict(BENCH, opt_iters=iters)
        j64, p64 = _solve_both(np.float64, params, start, goal)
        j32, p32 = _solve_both(np.float32, params, start, goal)
        scale = float(np.abs(p64[0]).max())

        def gap(a, b):
            lane = np.abs(a[0] - b[0]).reshape(B, -1).max(1) / scale
            return {"max": float(lane.max()),
                    "median_lane": float(np.median(lane))}

        out["iterations_%d" % iters] = {
            "jax64_vs_port64": gap(j64, p64), "jax32_vs_port32": gap(j32, p32),
            "port32_vs_port64": gap(p32, p64),
            "jax32_vs_jax64": gap(j32, j64)}
    print(json.dumps({"B": B, "H": H, "rel_to_max_x": out}))
