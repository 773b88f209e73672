"""``ilqr_solve`` past eight joints against the JAX package: the dual-arm
TIAGo (d = 14, EnvTableShelf, free start and goal draws) and config 4's
two Pandas and a UR10 (d = 20), B = 4, H = 8, 3 iterations at the iLQR
bench's weights (kg / r = 4e10), in float64, where the two packages differ
by op order only (1e-8 relative, as tests/test_torch_ilqr.py and
tests/test_torch_mpc_float64.py hold the Panda); and
``ilqr_solve_sharded`` at the TIAGo's d = 14.  On the CPU the port's
default ``riccati="kernel"`` takes the plain sweeps these cells reach on
the card through the shared routes of K6 and K7.

The JAX side runs its batched-QR form (``riccati="qr"``, the same
recursion as its default, whose lanes sweep takes ~12 s longer to
compile here) and compiles each solve once (~30 s for the TIAGo, ~65 s
for config 4 on the CPU), so config 4's comparison is marked slow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multi_robot import (CONFIG4, export_jax_multirobot_task,
                                    jax_task)
from test_torch_tiago import _jax_tiago

from torch_robotics_tpu.envs import EnvTableShelf as JEnvTableShelf
from torch_robotics_tpu.solve.ilqr import ILQRParams as JILQRParams
from torch_robotics_tpu.solve.ilqr import ilqr_solve as jax_ilqr_solve
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.envs import EnvTableShelf
from torch_robotics_tpu_torch.parallel import (ilqr_solve_sharded,
                                               make_mesh, shard_batch)
from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve
from torch_robotics_tpu_torch.tasks import zoo_tasks as zt

B, H, ITERS = 4, 8, 3
# the bench's iLQR weights (benchmarks/ilqr_sgpmp_bench.py:106-108)
BENCH = dict(n_support_points=H, dt=0.04, opt_iters=ITERS, sigma_coll=2e-3,
             sigma_goal_prior=5e-3, sigma_limits=5e-3, r_control=1e-6)
TOL_F64 = 1e-8


def _port(task, start, goal, **kw):
    res = ilqr_solve(task.collision_residuals,
                     torch.as_tensor(start, dtype=torch.float64),
                     torch.as_tensor(goal, dtype=torch.float64),
                     ILQRParams(**dict(BENCH, **kw)),
                     q_limits=(task.robot.q_min, task.robot.q_max))
    assert all(a.dtype == torch.float64 for a in res)
    return [a.numpy() for a in res]


def _jax(jtask, start, goal):
    with jax.enable_x64(True):
        res = jax_ilqr_solve(
            jtask.collision_residuals, jnp.asarray(start, jnp.float64),
            jnp.asarray(goal, jnp.float64),
            JILQRParams(riccati="qr", **BENCH),
            q_limits=(jtask.robot.q_min, jtask.robot.q_max))
        return [np.asarray(a, np.float64) for a in res]


def _assert_solves(got, ref, d):
    for name, g, r in zip(("trajs", "controls", "costs", "cost_trace"),
                          got, ref):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=TOL_F64,
                                   atol=TOL_F64 * float(np.abs(r).max()),
                                   err_msg=name)
    assert got[0].shape == (B, H, 2 * d)
    assert np.abs(got[0] - got[0][:, :1]).max() > 1e-2          # it moved
    assert (np.diff(got[3], axis=0) <= 0).all()   # only improving steps


def _config4_problem():
    """Config 4 exported from the JAX package; starts inside the joint box
    (most collide: the hinge rows are busy), goals clip(q0 + 0.4 N(0, 1))
    as config 4 draws them (tests/test_torch_mpc_multi.py)."""
    jtask = jax_task(CONFIG4)
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    rng = np.random.default_rng(0)
    lo, hi = ptask.robot.q_min.numpy(), ptask.robot.q_max.numpy()
    q0 = lo + rng.uniform(0.3, 0.7, size=(B, lo.shape[0])) * (hi - lo)
    qg = np.clip(q0 + 0.4 * rng.normal(size=q0.shape), lo, hi)
    z = np.zeros_like(q0)
    return (jtask, ptask, np.concatenate([q0, z], -1),
            np.concatenate([qg, z], -1))


@pytest.fixture(scope="module")
def tiago():
    """The TIAGo's task in the port, its B free start and goal draws and
    the port's float64 solve of them."""
    task = zt.tiago_dual_task(EnvTableShelf(device="cpu"), device="cpu")
    start, goal = zt.free_start_goal(task, B)
    return task, start, goal, _port(task, start, goal)


def test_tiago_ilqr_matches_jax_float64(tiago):
    """The TIAGo's task built alike in both packages (float32 parameters,
    as tests/test_torch_tiago.py), solved in float64."""
    task, start, goal, got = tiago
    with jax.enable_x64(True):
        jtask = JPlanningTask(env=JEnvTableShelf(), robot=_jax_tiago(),
                              obstacle_cutoff_margin=0.03)
    _assert_solves(got, _jax(jtask, start, goal), 14)


def test_ilqr_sharded_takes_fourteen_joints(tiago):
    """``ilqr_solve_sharded`` over a two-entry CPU mesh at the TIAGo's d =
    14 (the shared route's width on the card): the same trajectories,
    controls and mean cost as one ``ilqr_solve`` over the whole batch, in
    float64 (at the bench weights, kg / r = 4e10, a float32 lane's last
    bits depend on the batch it is vectorised with)."""
    task, start, goal, one = tiago
    mesh = make_mesh(devices=["cpu", "cpu"])
    res, gmean = ilqr_solve_sharded(
        task.collision_residuals,
        shard_batch(torch.as_tensor(start, dtype=torch.float64), mesh),
        shard_batch(torch.as_tensor(goal, dtype=torch.float64), mesh),
        ILQRParams(**BENCH), mesh,
        q_limits=(task.robot.q_min, task.robot.q_max))
    assert tuple(res.trajs.shape) == (B, H, 28)
    for a, b in zip(res, one):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-9)
    assert float(gmean) == pytest.approx(float(one[2].mean()), rel=1e-9)


@pytest.mark.slow
def test_config4_ilqr_matches_jax_float64():
    jtask, ptask, start, goal = _config4_problem()
    _assert_solves(_port(ptask, start, goal), _jax(jtask, start, goal), 20)
