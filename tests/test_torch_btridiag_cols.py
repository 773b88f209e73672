"""The port's large-m block-tridiagonal solve (plain version of the CUDA
column sweep) vs the JAX package on the same numpy inputs, the routing of
``solve_lanes_auto``, and the column sweep's algorithm.

Tolerances: against JAX's column kernel in interpret mode, the JAX test's
own (tests/test_pallas_btridiag.py: rtol 1e-4, atol 1e-5; float32 sums in
another order); in float64, 1e-10 of max|x| (op order only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_btridiag import _dense_solve, _system
from torch_robotics_tpu.ops.pallas_btridiag import \
    solve_lanes_pallas_cols as jax_solve_lanes_pallas_cols
from torch_robotics_tpu.solve.btridiag import \
    block_tridiag_solve as jax_block_tridiag_solve
from torch_robotics_tpu.solve.btridiag_lanes import \
    solve_lanes_core as jax_solve_lanes_core
from torch_robotics_tpu_torch.ops.btridiag_kernel import (solve_lanes_auto,
                                                          solve_lanes_cols)
from torch_robotics_tpu_torch.solve.btridiag_lanes import solve_lanes_core


def test_plain_solve_matches_jax_column_kernel_at_m40():
    """The JAX column kernel's test shape (H, m, B) = (4, 40, 128): the
    port's plain sweep vs JAX's ``solve_lanes_pallas_cols`` (interpret,
    trsv backward tail) and JAX's ``solve_lanes_core``."""
    D, U, b = _system(4, 40, 128, seed=40)
    got = solve_lanes_cols(*map(torch.as_tensor, (D, U, b))).numpy()
    jD, jU, jb = map(jnp.asarray, (D, U, b))
    ref_kernel = np.asarray(jax_solve_lanes_pallas_cols(
        jD, jU, jb, tile_b=128, interpret=True, bwd_trsv=True))
    ref_core = np.asarray(jax_solve_lanes_core(jD, jU, jb))
    for ref in (ref_kernel, ref_core):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_float64_plain_solve_matches_jax_tiled_solver():
    """On the CPU the JAX GN step solves m > 32 with its tiled
    ``block_tridiag_solve``; the port keeps the plain lanes sweep.  The two
    are the same solve: held together in float64."""
    D, U, b = (a.astype(np.float64) for a in _system(5, 40, 6, seed=41))
    with jax.enable_x64(True):
        ref = np.asarray(jax_block_tridiag_solve(
            jnp.asarray(np.transpose(D, (3, 0, 1, 2))),
            jnp.asarray(U[:-1, :, :, 0]),
            jnp.asarray(np.transpose(b, (2, 0, 1)))))
    got = solve_lanes_core(*map(torch.as_tensor, (D, U, b))).numpy()
    np.testing.assert_allclose(np.transpose(got, (2, 0, 1)), ref,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("m", [4, 14, 16, 18, 40])
def test_auto_takes_the_plain_version_on_cpu_for_every_m(m):
    D, U, b = map(torch.as_tensor, _system(3, m, 5, seed=m))
    assert torch.equal(solve_lanes_auto(D, U, b), solve_lanes_core(D, U, b))
    assert torch.equal(solve_lanes_cols(D, U, b), solve_lanes_core(D, U, b))


def test_cols_wrapper_refuses_per_batch_u():
    D, U, b = _system(3, 20, 4, seed=5, per_batch_u=True)
    with pytest.raises(ValueError, match="per-batch U"):
        solve_lanes_cols(*map(torch.as_tensor, (D, U, b)))


def _pair_table(m):
    """The column sweep's pair table (btridiag_cols.cu): (row, col) of the
    bordered matrix's lower triangle, col >= 1, from the last column back."""
    n2 = 2 * m + 1
    return [(r, c) for c in range(2 * m, 0, -1) for r in range(c, n2)]


def _bordered_sweep(D, U, b):
    """float64 numpy model of btridiag_cols.cu for one lane at a time: each
    block step eliminates the first m columns of [[A, U, c], [U^T, 0, 0],
    [c^T, 0, 0]] (A = D_k - S, c = b_k - Wy) in place, updating exactly the
    entries of the pair table's first tri(2m - j) pairs at column j, then
    reads L_k, y_k and the next step's -S, -Wy off the matrix; the backward
    pass is x_k = L_k^-T (y_k - L_k^-1 (U_k x_{k+1}))."""
    H, m, _, B = D.shape
    n2 = 2 * m + 1
    pairs = np.asarray(_pair_table(m))
    x = np.zeros((H, m, B))
    for lane in range(B):
        M = np.zeros((n2, n2))
        Ls, ys = [], []
        for k in range(H):
            carry_S = M[m:2 * m, m:2 * m].copy()
            carry_wy = M[2 * m, m:2 * m].copy()
            M = np.zeros((n2, n2))
            M[:m, :m] = np.tril(D[k, :, :, lane] + carry_S)
            M[2 * m, :m] = b[k, :, lane] + carry_wy
            M[m:2 * m, :m] = U[k, :, :, 0].T
            for j in range(m):
                p = np.sqrt(M[j, j])
                cnt = (2 * m - j) * (2 * m - j + 1) // 2
                r, c = pairs[:cnt, 0], pairs[:cnt, 1]
                assert (c > j).all() and (r >= c).all()
                M[r, c] -= (M[r, j] / p) * (M[c, j] / p)
                M[j + 1:, j] /= p
                M[j, j] = p
            Ls.append(np.tril(M[:m, :m]))
            ys.append(M[2 * m, :m].copy())
        xk1 = None
        for k in reversed(range(H)):
            L = Ls[k]
            rhs = ys[k]
            if xk1 is not None:
                rhs = rhs - np.linalg.solve(L, U[k, :, :, 0] @ xk1)
            xk1 = np.linalg.solve(L.T, rhs)
            x[k, :, lane] = xk1
    return x


@pytest.mark.parametrize("H,m,B", [(4, 5, 3), (3, 18, 2)])
def test_column_sweep_algorithm_solves_the_system(H, m, B):
    """The CUDA column sweep's bordered-matrix form (modelled step by step in
    float64) is the block-tridiagonal solve: it agrees with the plain sweep
    and a dense solve; its pair table covers each step's trailing lower
    triangle exactly once."""
    pairs = _pair_table(m)
    for j in range(m):
        cnt = (2 * m - j) * (2 * m - j + 1) // 2
        want = {(r, c) for c in range(j + 1, 2 * m + 1)
                for r in range(c, 2 * m + 1)}
        assert set(pairs[:cnt]) == want and len(pairs[:cnt]) == len(want)
    D, U, b = (a.astype(np.float64) for a in _system(H, m, B, seed=H * m))
    got = _bordered_sweep(D, U, b)
    ref = solve_lanes_core(*map(torch.as_tensor, (D, U, b))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(got, _dense_solve(D, U, b),
                               atol=1e-10 * np.abs(ref).max())
