"""The port's sharding layer (``parallel/mesh.py``) on a two-entry CPU mesh
(``make_mesh(devices=["cpu", "cpu"])``), mirroring tests/test_parallel.py.

Each wrapper is held to the unsharded port solver (1e-5, the reference
test's tolerance: shares change only the batch size of the same per-lane
math) and, in float64, to the JAX package's wrapper on its 8-device CPU
mesh (1e-8 of max|x|; the sGPMP wrappers draw their noise from different
generators, so there the two packages are held to the same statistics).
Chunked equals unchunked; padded rows are left out of the statistics; the
sGPMP chunks draw distinct noise.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu import parallel as jpar
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.chomp import CHOMPParams as JCHOMPParams
from torch_robotics_tpu.solve.ilqr import ILQRParams as JILQRParams
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.sampling import SGPMPParams as JSGPMPParams
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvDense2D
from torch_robotics_tpu_torch.parallel import (chomp_solve_sharded,
                                               ilqr_solve_sharded, make_mesh,
                                               mpc_rollout_sharded,
                                               replicate, sgpmp_solve_sharded,
                                               shard_batch,
                                               shard_batch_padded,
                                               solve_sharded)
from torch_robotics_tpu_torch.parallel.mesh import _chunked
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import (CHOMPParams, GPMP2Params,
                                            ILQRParams, MPCParams,
                                            SGPMPParams, chomp_solve,
                                            gpmp2_init_trajs, gpmp2_solve,
                                            ilqr_solve, mpc_rollout)
from torch_robotics_tpu_torch.tasks import PlanningTask

GP = dict(n_support_points=16, dt=0.04, opt_iters=20, sigma_start=1e-4,
          sigma_gp=1e-2, sigma_goal_prior=1e-4, sigma_coll=1e-3,
          step_size=0.5, sigma_gp_init=0.05)
CHOMP = dict(n_support_points=16, dt=0.04, opt_iters=10, sigma_coll=1e-2)
ILQR = dict(n_support_points=16, dt=0.04, opt_iters=5, sigma_coll=1e-2,
            sigma_goal_prior=1e-2)
START = np.array([-0.9, -0.9, 0.0, 0.0])
GOAL = np.array([0.9, 0.9, 0.0, 0.0])
TOL = 1e-5
TOL_JAX64 = 1e-8


@pytest.fixture(scope="module")
def tasks():
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01)
    ptask = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=0.01)
    return jtask, ptask


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu", "cpu"])


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def theta0(n, seed):
    return gpmp2_init_trajs(torch.Generator().manual_seed(seed),
                            GPMP2Params(**GP), t(START), t(GOAL),
                            num_samples=n)


def endpoint_batch(B, seed=7):
    delta = 0.05 * np.random.default_rng(seed).normal(size=(B, 2))
    s = np.concatenate([np.array([-0.9, -0.9]) + delta, np.zeros((B, 2))], -1)
    g = np.concatenate([np.array([0.9, 0.9]) - delta, np.zeros((B, 2))], -1)
    return s, g


def near(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().double().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def test_mesh_helpers(mesh, monkeypatch):
    assert mesh == [torch.device("cpu")] * 2
    assert make_mesh(1, devices=["cpu", "cpu"]) == [torch.device("cpu")]
    x = torch.arange(12.0).reshape(6, 2)
    shares = shard_batch(x, mesh)
    assert [tuple(s.shape) for s in shares] == [(3, 2), (3, 2)]
    assert torch.equal(torch.cat(shares), x)
    with pytest.raises(ValueError, match="shard_batch_padded"):
        shard_batch(x[:5], mesh)
    padded, n_valid = shard_batch_padded(x[:5], mesh)
    assert n_valid == 5 and torch.equal(padded[1][-1], x[4])
    assert all(torch.equal(r, x) for r in replicate(x, mesh))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_solve_sharded_matches_single_device_and_jax(tasks, mesh):
    jtask, ptask = tasks
    params = GPMP2Params(**GP)
    th = theta0(16, 0)
    single = gpmp2_solve(ptask.collision_residuals, th, t(START), t(GOAL),
                         params)
    trajs, gmean = solve_sharded(ptask.collision_residuals,
                                 shard_batch(th, mesh), t(START), t(GOAL),
                                 params, mesh)
    near(trajs, single.trajs, TOL)
    assert abs(float(gmean) - float(single.costs.mean())) <= \
        TOL * float(single.costs.abs().max())
    with jax.enable_x64(True):
        jmesh = jpar.make_mesh()
        jt, jm = jpar.solve_sharded(
            jtask.collision_residuals,
            jpar.shard_batch(jnp.asarray(th.double().numpy()), jmesh),
            jnp.asarray(START), jnp.asarray(GOAL), JGPMP2Params(**GP), jmesh)
        jt, jm = np.asarray(jt), float(jm)
    t64, m64 = solve_sharded(ptask.collision_residuals, th.double(),
                             t(START, torch.float64), t(GOAL, torch.float64),
                             params, mesh)
    near(t64, jt, TOL_JAX64)
    assert abs(float(m64) - jm) <= TOL_JAX64 * abs(jm)


def test_mpc_rollout_sharded_matches_single_device_and_jax(tasks, mesh):
    """Per-problem endpoints, 6 steps of one GN iteration."""
    jtask, ptask = tasks
    params = MPCParams(gpmp2=GPMP2Params(**GP), iters_per_step=1)
    s, g = endpoint_batch(16, seed=4)
    xs_plain, info = mpc_rollout(ptask.collision_residuals, t(s), t(g),
                                 params, n_steps=6)
    xs, frac = mpc_rollout_sharded(ptask.collision_residuals,
                                   shard_batch(t(s), mesh),
                                   shard_batch(t(g), mesh), params, 6, mesh)
    near(xs, xs_plain, TOL)
    assert float(frac) == pytest.approx(
        float((info["dist_to_goal"][-1] < 0.1).float().mean()))
    with jax.enable_x64(True):
        jmesh = jpar.make_mesh()
        jxs, jfrac = jpar.mpc_rollout_sharded(
            jtask.collision_residuals, jpar.shard_batch(jnp.asarray(s), jmesh),
            jpar.shard_batch(jnp.asarray(g), jmesh),
            JMPCParams(gpmp2=JGPMP2Params(**GP), iters_per_step=1), 6, jmesh)
        jxs, jfrac = np.asarray(jxs), float(jfrac)
    xs64, frac64 = mpc_rollout_sharded(
        ptask.collision_residuals, t(s, torch.float64), t(g, torch.float64),
        params, 6, mesh)
    near(xs64, jxs, TOL_JAX64)
    assert float(frac64) == pytest.approx(jfrac)


def test_mpc_rollout_sharded_chunked_matches_unchunked(tasks, mesh):
    """Chunks of 2 over shares of 16 are a schedule change only; a chunk
    that does not divide the share runs it in one call, with a warning."""
    _, ptask = tasks
    params = MPCParams(gpmp2=GPMP2Params(**GP), iters_per_step=1)
    s, g = endpoint_batch(32, seed=5)
    xs_un, frac_un = mpc_rollout_sharded(ptask.collision_residuals, t(s),
                                         t(g), params, 4, mesh, chunk=None)
    xs_ch, frac_ch = mpc_rollout_sharded(ptask.collision_residuals, t(s),
                                         t(g), params, 4, mesh, chunk=2)
    near(xs_ch, xs_un.numpy(), TOL)
    assert float(frac_ch) == pytest.approx(float(frac_un), abs=1e-6)
    with pytest.warns(UserWarning, match="does not divide"):
        xs_odd, _ = mpc_rollout_sharded(ptask.collision_residuals, t(s),
                                        t(g), params, 4, mesh, chunk=3)
    near(xs_odd, xs_un.numpy(), TOL)


def test_chunked_runs_chunk_by_chunk_in_order():
    calls = []

    def body(a, c):
        calls.append((c, a[0].shape[0]))
        return (a[0] * 2, a[1][:, :1])
    x, y = torch.arange(8.0), torch.arange(16.0).reshape(8, 2)
    out = _chunked(body, (x, y), 2)
    assert calls == [(0, 2), (1, 2), (2, 2), (3, 2)]
    assert torch.equal(out[0], x * 2) and torch.equal(out[1], y[:, :1])
    calls.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _chunked(body, (x, y), None)
        _chunked(body, (x, y), 8)
    assert calls == [(0, 8), (0, 8)]


def test_ilqr_sharded_matches_single_device_and_jax(tasks, mesh):
    jtask, ptask = tasks
    params = ILQRParams(**ILQR)
    s, g = endpoint_batch(16)
    plain = ilqr_solve(ptask.collision_residuals, t(s), t(g), params)
    res, gmean = ilqr_solve_sharded(ptask.collision_residuals,
                                    shard_batch(t(s), mesh),
                                    shard_batch(t(g), mesh), params, mesh)
    near(res.trajs, plain.trajs, TOL)
    near(res.controls, plain.controls, TOL)
    assert tuple(res.cost_trace.shape) == (5, 16)
    near(res.cost_trace, plain.cost_trace, 1e-4)
    assert float(gmean) == pytest.approx(float(plain.costs.mean()), rel=TOL)
    with jax.enable_x64(True):
        jmesh = jpar.make_mesh()
        jres, jm = jpar.ilqr_solve_sharded(
            jtask.collision_residuals, jpar.shard_batch(jnp.asarray(s), jmesh),
            jpar.shard_batch(jnp.asarray(g), jmesh), JILQRParams(**ILQR),
            jmesh)
        jtr, jm = np.asarray(jres.trajs), float(jm)
    r64, m64 = ilqr_solve_sharded(ptask.collision_residuals,
                                  t(s, torch.float64), t(g, torch.float64),
                                  params, mesh)
    near(r64.trajs, jtr, TOL_JAX64)
    assert float(m64) == pytest.approx(jm, rel=TOL_JAX64)


def test_ilqr_sharded_optionals_padded_chunked(tasks, mesh):
    """q_limits shared, warm-start controls sharded, an uneven batch
    through shard_batch_padded and chunks of one, all at once: the padded
    row is left out of the mean."""
    _, ptask = tasks
    robot = ptask.robot
    params = ILQRParams(**dict(ILQR, opt_iters=3, sigma_limits=1e-1))
    s, g = endpoint_batch(13)
    u0 = torch.zeros((13, 15, 2))
    qlim = (robot.q_min, robot.q_max)
    plain = ilqr_solve(ptask.collision_residuals, t(s), t(g), params,
                       u_init=u0, q_limits=qlim)
    s_p, n_valid = shard_batch_padded(t(s), mesh)
    g_p, _ = shard_batch_padded(t(g), mesh)
    u_p, _ = shard_batch_padded(u0, mesh)
    res, gmean = ilqr_solve_sharded(ptask.collision_residuals, s_p, g_p,
                                    params, mesh, u_init=u_p, q_limits=qlim,
                                    n_valid=n_valid, chunk=1)
    assert n_valid == 13 and tuple(res.trajs.shape) == (14, 16, 4)
    near(res.trajs[:13], plain.trajs, TOL)
    assert float(gmean) == pytest.approx(float(plain.costs.mean()), rel=TOL)


def test_chomp_sharded_matches_single_device_and_jax(tasks, mesh):
    jtask, ptask = tasks
    params = CHOMPParams(**CHOMP)
    th = theta0(16, 1)
    plain = chomp_solve(ptask.collision_residuals, th, t(START), t(GOAL),
                        params)
    res, gmean = chomp_solve_sharded(ptask.collision_residuals,
                                     shard_batch(th, mesh), t(START),
                                     t(GOAL), params, mesh)
    near(res.trajs, plain.trajs, TOL)
    assert tuple(res.cost_trace.shape) == (10,)
    near(res.cost_trace, plain.cost_trace, 1e-4)
    assert float(gmean) == pytest.approx(float(plain.cost_trace[-1]) / 16,
                                         rel=1e-4)
    with jax.enable_x64(True):
        jmesh = jpar.make_mesh()
        jres, jm = jpar.chomp_solve_sharded(
            jtask.collision_residuals,
            jpar.shard_batch(jnp.asarray(th.double().numpy()), jmesh),
            jnp.asarray(START), jnp.asarray(GOAL), JCHOMPParams(**CHOMP),
            jmesh)
        jtr, jtrace, jm = (np.asarray(jres.trajs),
                           np.asarray(jres.cost_trace), float(jm))
    r64, m64 = chomp_solve_sharded(ptask.collision_residuals, th.double(),
                                   t(START, torch.float64),
                                   t(GOAL, torch.float64), params, mesh)
    near(r64.trajs, jtr, TOL_JAX64)
    near(r64.cost_trace, jtrace, TOL_JAX64)
    assert float(m64) == pytest.approx(jm, rel=TOL_JAX64)


def test_chomp_sharded_padded_excludes_duplicates(tasks, mesh):
    _, ptask = tasks
    params = CHOMPParams(**CHOMP)
    th = theta0(13, 1)
    plain = chomp_solve(ptask.collision_residuals, th, t(START), t(GOAL),
                        params, per_problem_trace=True)
    padded, n_valid = shard_batch_padded(th, mesh)
    res, gmean = chomp_solve_sharded(ptask.collision_residuals, padded,
                                     t(START), t(GOAL), params, mesh,
                                     n_valid=n_valid)
    trace_valid = plain.cost_trace.numpy()                   # (iters, 13)
    np.testing.assert_allclose(res.cost_trace.numpy(),
                               trace_valid.sum(axis=1), rtol=1e-4)
    assert float(gmean) == pytest.approx(float(trace_valid[-1].mean()),
                                         rel=1e-4)
    near(res.trajs[:13], plain.trajs, TOL)


SG = dict(n_support_points=16, dt=0.04, opt_iters=10, num_samples=8,
          sigma_coll=1e-2, sigma_gp_sample=0.05)


def test_sgpmp_sharded_converges_as_jax_does(tasks, mesh):
    """Statistically equivalent, not bit for bit: shapes, finiteness, and
    every problem's cost not above its start in both packages; the same
    generator seed gives the same result."""
    jtask, ptask = tasks
    params = SGPMPParams(**SG)
    th = theta0(16, 2)
    res, gmean = sgpmp_solve_sharded(
        ptask.collision_residuals, shard_batch(th, mesh), t(START), t(GOAL),
        params, mesh, generator=torch.Generator().manual_seed(3))
    assert tuple(res.trajs.shape) == (16, 16, 4)
    assert tuple(res.cost_trace.shape) == (10, 16)
    assert bool(torch.isfinite(res.trajs).all()) and bool(
        torch.isfinite(gmean))
    assert bool((res.cost_trace[-1] <= res.cost_trace[0]).all())
    assert float(gmean) == pytest.approx(float(res.cost_trace[-1].mean()),
                                         rel=1e-6)
    again, _ = sgpmp_solve_sharded(
        ptask.collision_residuals, th, t(START), t(GOAL), params, mesh,
        generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.trajs, res.trajs)
    jmesh = jpar.make_mesh()
    jres, jm = jpar.sgpmp_solve_sharded(
        jtask.collision_residuals,
        jpar.shard_batch(jnp.asarray(th.numpy()), jmesh),
        jnp.asarray(START, jnp.float32), jnp.asarray(GOAL, jnp.float32),
        JSGPMPParams(**SG), jmesh,
        key=jax.random.PRNGKey(3))
    assert jres.trajs.shape == tuple(res.trajs.shape)
    assert jres.cost_trace.shape == tuple(res.cost_trace.shape)
    assert bool(jnp.all(jres.cost_trace[-1] <= jres.cost_trace[0]))


def test_sgpmp_sharded_chunked_distinct_noise(tasks, mesh):
    """Identical problems in different chunks of one share draw distinct
    perturbation streams: not bit-identical trajectories."""
    _, ptask = tasks
    params = SGPMPParams(**dict(SG, opt_iters=5, num_samples=4))
    one = theta0(4, 2)
    th = one[:1].expand(8, -1, -1).contiguous()
    res, _ = sgpmp_solve_sharded(ptask.collision_residuals, th, t(START),
                                 t(GOAL), params, mesh,
                                 generator=torch.Generator().manual_seed(3),
                                 chunk=2)
    tr = res.trajs.numpy()
    assert bool(np.isfinite(tr).all())
    # share 0 holds rows 0-3: chunks (0, 1) and (2, 3); share 1 rows 4-7
    assert not np.allclose(tr[0], tr[2]), "chunks drew the same noise"
    assert not np.allclose(tr[0], tr[4]), "shares drew the same noise"
    # within a chunk the problems share a generator but not their normals
    assert not np.allclose(tr[0], tr[1])


def test_several_devices_take_a_residual_function_each(tasks):
    """Two distinct devices with one residual function: refused, since a
    task's tensors live on one device."""
    _, ptask = tasks
    mesh2 = [torch.device("cpu"), torch.device("meta")]
    th = theta0(4, 0)
    with pytest.raises(ValueError, match="residual function per mesh"):
        solve_sharded(ptask.collision_residuals, th, t(START), t(GOAL),
                      GPMP2Params(**GP), mesh2)
