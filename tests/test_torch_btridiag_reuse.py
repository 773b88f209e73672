"""GN factorization reuse: the port's plain factor-persisting sweep and
substitution-only re-solve (the plain versions of the CUDA kernels in
csrc/btridiag.cu) vs the JAX package's Pallas kernels in interpret mode,
and the port's reuse schedule vs the JAX package's on the same numpy
inputs.

Tolerance as tests/test_torch_btridiag.py: 1e-5 of max|x| (and of max|L|,
max|W|), float32 op order (the TPU kernels multiply by reciprocal pivots
where the plain sweep divides).  L is compared whole, its zero strict
upper triangle included.  At m = 14 the JAX factor kernel takes minutes to
interpret, so there the factors are held to the dense float64 Cholesky of
the same system (its block bidiagonal factor has L_k on the diagonal and
W_k^T below it) and the JAX substitution kernel runs on the port's
factors."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.ops.pallas_btridiag import (
    solve_lanes_pallas_factor, solve_lanes_pallas_subst)
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve.gp_prior import \
    straight_line_trajs as jax_straight_line_trajs
from torch_robotics_tpu.solve.gpmp2 import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.gpmp2 import _gpmp2_solve_reuse
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvDense2D
from torch_robotics_tpu_torch.ops.btridiag_kernel import (solve_lanes_factor,
                                                          solve_lanes_subst)
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_solve
from torch_robotics_tpu_torch.solve.btridiag_lanes import (
    solve_lanes_core, solve_lanes_factor_core, solve_lanes_subst_core)
from torch_robotics_tpu_torch.tasks import PlanningTask

from test_torch_btridiag import _system

TOL = 1e-5


def _close(got, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=TOL * float(np.abs(ref).max()))


def _dense_factors(D, U):
    """Block factors of the dense float64 Cholesky of each lane's system:
    (L (H, m, m, B), W (H, m, m, B)), W_{H-1} = L_{H-1}^-1 U_{H-1}."""
    H, m, _, B = D.shape
    L = np.zeros((H, m, m, B))
    W = np.zeros((H, m, m, B))
    for k in range(B):
        A = np.zeros((H * m, H * m))
        for t in range(H):
            A[t * m:(t + 1) * m, t * m:(t + 1) * m] = D[t, :, :, k]
            if t + 1 < H:
                A[t * m:(t + 1) * m, (t + 1) * m:(t + 2) * m] = U[t, :, :, 0]
                A[(t + 1) * m:(t + 2) * m, t * m:(t + 1) * m] = U[t, :, :, 0].T
        C = np.linalg.cholesky(A)
        for t in range(H):
            L[t, :, :, k] = C[t * m:(t + 1) * m, t * m:(t + 1) * m]
            if t + 1 < H:
                W[t, :, :, k] = C[(t + 1) * m:(t + 2) * m,
                                  t * m:(t + 1) * m].T
            else:
                W[t, :, :, k] = np.linalg.solve(L[t, :, :, k], U[t, :, :, 0])
    return L, W


def _assert_lower(L):
    assert bool((torch.triu(L.permute(0, 3, 1, 2), 1) == 0).all())


def test_factor_and_subst_match_jax_interpret():
    """(H, m, B) = (8, 4, 128): x, L and W of the factor sweep, x of the
    substitution from the port's own factors and from JAX's."""
    D, U, b = _system(8, 4, 128, seed=32)
    b2 = np.random.default_rng(4).normal(size=b.shape).astype(np.float32)
    jx, jL, jW = solve_lanes_pallas_factor(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(b), tile_b=128,
        interpret=True)
    jx2 = solve_lanes_pallas_subst(jL, jW, jnp.asarray(b2), tile_b=128,
                                   interpret=True)
    x, L, W = solve_lanes_factor_core(*map(torch.as_tensor, (D, U, b)))
    for got, ref in ((x, jx), (L, jL), (W, jW)):
        _close(got, ref)
    _assert_lower(L)
    _close(solve_lanes_subst_core(L, W, torch.as_tensor(b2)), jx2)
    _close(solve_lanes_subst_core(torch.tensor(np.asarray(jL)),
                                  torch.tensor(np.asarray(jW)),
                                  torch.as_tensor(b2)), jx2)


def test_m14_factors_match_float64_and_subst_matches_jax_interpret():
    """(H, m, B) = (2, 14, 128), the reuse workload's state block."""
    D, U, b = _system(2, 14, 128, seed=28)
    x, L, W = solve_lanes_factor_core(*map(torch.as_tensor, (D, U, b)))
    L64, W64 = _dense_factors(D.astype(np.float64), U.astype(np.float64))
    _close(L, L64)
    _close(W, W64)
    _assert_lower(L)
    b2 = np.random.default_rng(14).normal(size=b.shape).astype(np.float32)
    jx2 = solve_lanes_pallas_subst(jnp.asarray(L.numpy()),
                                   jnp.asarray(W.numpy()), jnp.asarray(b2),
                                   tile_b=128, interpret=True)
    _close(solve_lanes_subst_core(L, W, torch.as_tensor(b2)), jx2)


def test_factor_is_the_plain_solve_and_subst_solves_the_original_system():
    D, U, b = map(torch.as_tensor, _system(6, 4, 33, seed=2))
    x, L, W = solve_lanes_factor_core(D, U, b)
    assert torch.equal(x, solve_lanes_core(D, U, b))
    b2 = torch.as_tensor(np.random.default_rng(3).normal(
        size=b.shape).astype(np.float32))
    x2 = solve_lanes_subst_core(L, W, b2)
    ref = solve_lanes_core(D, U, b2)
    np.testing.assert_allclose(x2.numpy(), ref.numpy(),
                               atol=TOL * float(ref.abs().max()))
    # CPU tensors take the plain versions through the wrappers
    got = solve_lanes_factor(D, U, b)
    assert all(torch.equal(a, r) for a, r in zip(got, (x, L, W)))
    assert torch.equal(solve_lanes_subst(L, W, b2), x2)


@pytest.fixture(scope="module")
def reuse_setup():
    """tests/test_solve_gpmp2.py's reuse test: point mass in EnvDense2D,
    cutoff 0.01, B = 128, H = 8, 6 iterations from straight lines."""
    B, H = 128, 8
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01)
    ptask = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=0.01)
    start = np.asarray([-0.9, -0.9, 0.0, 0.0], np.float32)
    goal = np.asarray([0.9, 0.9, 0.0, 0.0], np.float32)
    theta0 = np.array(jax_straight_line_trajs(
        jnp.tile(start, (B, 1)), jnp.tile(goal, (B, 1)), H))
    p = GPMP2Params(n_support_points=H, dt=0.1, opt_iters=6,
                    sigma_start=1e-3, sigma_gp=1e-1, sigma_goal_prior=1e-3,
                    sigma_coll=1e-3, step_size=0.5)
    return jtask, ptask, theta0, start, goal, p


def _port(ptask, theta0, start, goal, p):
    return gpmp2_solve(ptask.collision_residuals, torch.as_tensor(theta0),
                       torch.as_tensor(start), torch.as_tensor(goal), p)


def test_reuse_schedule_matches_jax(reuse_setup):
    """refactor_every = 2 on the CPU takes the reuse schedule (factor,
    substitution, ...) through the plain sweeps: the JAX package's
    _gpmp2_solve_reuse with its kernels in interpret mode."""
    jtask, ptask, theta0, start, goal, p = reuse_setup
    p2 = dataclasses.replace(p, refactor_every=2)
    ref = _gpmp2_solve_reuse(
        jtask.collision_residuals.obstacle_terms_lanes, jnp.asarray(theta0),
        jnp.asarray(start), jnp.asarray(goal),
        JGPMP2Params(**dataclasses.asdict(p2)), None, 128, interpret=True)
    got = _port(ptask, theta0, start, goal, p2)
    np.testing.assert_allclose(got.trajs.numpy(), np.asarray(ref.trajs),
                               rtol=1e-5, atol=1e-5)
    # the cost is a float32 sum over rows weighted by lam = 1e6 (~6e3
    # here): op order leaves ~3e-5 relative
    np.testing.assert_allclose(got.cost_trace.numpy(),
                               np.asarray(ref.cost_trace), rtol=1e-4)
    # the substitution iterations moved the result off the plain solve
    plain = _port(ptask, theta0, start, goal, p)
    assert not torch.equal(got.trajs, plain.trajs)
    assert bool(torch.isfinite(got.trajs).all())


def test_refactor_every_1_is_the_plain_solve(reuse_setup):
    _, ptask, theta0, start, goal, p = reuse_setup
    plain = _port(ptask, theta0, start, goal, p)
    r1 = _port(ptask, theta0, start, goal,
               dataclasses.replace(p, refactor_every=1))
    assert torch.equal(r1.trajs, plain.trajs)
    assert torch.equal(r1.cost_trace, plain.cost_trace)


def test_reuse_above_m16_is_ignored_with_a_warning(reuse_setup):
    """m > 16 has no factor-persisting sweep: the option is ignored, as the
    reference ignores it, and the solve is the plain one."""
    p = dataclasses.replace(reuse_setup[-1], n_support_points=4)

    def zero_terms(q_cols, lam, h=None):
        """Obstacle-free lanes terms of a 9-joint robot (m = 18)."""
        d, N = q_cols.shape
        B = N // h
        return (q_cols.new_zeros((h, 2 * d, B)),
                q_cols.new_zeros((h, 2 * d, 2 * d, B)),
                q_cols.new_zeros((h, B)))

    class Residuals:
        obstacle_terms_lanes = staticmethod(zero_terms)

    rng = np.random.default_rng(5)
    theta = torch.as_tensor(rng.normal(size=(3, 4, 18)), dtype=torch.float32)
    s, g = theta[0, 0], theta[0, -1]
    plain = gpmp2_solve(Residuals(), theta, s, g, p)
    with pytest.warns(UserWarning, match="refactor_every=2 is ignored"):
        got = gpmp2_solve(Residuals(), theta, s, g,
                          dataclasses.replace(p, refactor_every=2))
    assert torch.equal(got.trajs, plain.trajs)
