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


def _bordered_sweep(D, U, b, width=None, pivot_padding=False, seen=None):
    """float64 numpy model of btridiag_cols.cu for one lane at a time.

    Each block step eliminates the first m columns of the bordered matrix
    [[A, ., .], [U^T, 0, .], [c^T, 0, 0]] (A = D_k - S, c = b_k - Wy) in
    place, column owner by column owner: at pivot j the owner of column
    c > j updates rows c..n2-1 of its column (the kernel's thread c), so
    each trailing entry is updated once per pivot (counted in ``seen``:
    pivot j -> the entries it updated).  L_k, y_k and the next step's -S,
    -Wy are read off the matrix; the backward pass is
    x_k = L_k^-T (y_k - L_k^-1 (U_k x_{k+1})).

    ``width`` pads the blocks to the kernel's padded width w >= m: A's
    padded columns are identity columns, the rows and columns of U past m
    and the padded right-hand side are zero, and the bordered matrix is
    2 w + 1 wide (U^T at rows w.., c at row 2 w).  Only the m real columns
    are pivoted, as in the kernel, unless ``pivot_padding``."""
    H, m, _, B = D.shape
    w = m if width is None else width
    n2 = 2 * w + 1
    x = np.zeros((H, m, B))
    for lane in range(B):
        M = np.zeros((n2, n2))
        Ls, ys = [], []
        for k in range(H):
            carry_S = M[w:w + m, w:w + m].copy()
            carry_wy = M[2 * w, w:w + m].copy()
            M = np.zeros((n2, n2))
            M[:m, :m] = np.tril(D[k, :, :, lane] + carry_S)
            M[range(m, w), range(m, w)] = 1.0
            M[2 * w, :m] = b[k, :, lane] + carry_wy
            M[w:w + m, :m] = U[k, :, :, 0].T
            for j in range(w if pivot_padding else m):
                p = np.sqrt(M[j, j])
                for c in range(j + 1, n2):          # the owner of column c
                    M[c:, c] -= (M[c:, j] / p) * (M[c, j] / p)
                    if seen is not None and lane == 0 and k == 0:
                        seen.setdefault(j, []).extend(
                            (r, c) for r in range(c, n2))
                M[j + 1:, j] /= p
                M[j, j] = p
            if w > m:
                # padding stays zero (and A's padded diagonal one)
                assert not M[m:w, :m].any() and not M[w + m:2 * w].any()
                assert not M[:, w + m:2 * w].any()
                assert not M[w:, m:w].any() and not M[m:w, m:w][
                    np.tril_indices(w - m, -1)].any()
                assert (np.diag(M)[m:w] == 1.0).all()
            Ls.append(np.tril(M[:m, :m]))
            ys.append(M[2 * w, :m].copy())
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
    and a dense solve; its column owners update each step's trailing lower
    triangle exactly once per pivot."""
    D, U, b = (a.astype(np.float64) for a in _system(H, m, B, seed=H * m))
    seen = {}
    got = _bordered_sweep(D, U, b, seen=seen)
    n2 = 2 * m + 1
    assert sorted(seen) == list(range(m))
    for j, entries in seen.items():
        want = {(r, c) for c in range(j + 1, n2) for r in range(c, n2)}
        assert set(entries) == want and len(entries) == len(want)
    ref = solve_lanes_core(*map(torch.as_tensor, (D, U, b))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(got, _dense_solve(D, U, b),
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("pivot_padding", [False, True])
@pytest.mark.parametrize("H,m,B,width", [(3, 18, 2, 24), (2, 33, 2, 40),
                                         (3, 5, 2, 8)])
def test_padded_width_leaves_real_lanes_bit_for_bit(H, m, B, width,
                                                     pivot_padding):
    """The kernel runs m in the next padded width (identity columns in A,
    zero rows and columns of U, a zero right-hand side): the real lanes'
    x is bit for bit the unpadded model's, whether or not the padded
    columns are pivoted (a padded pivot subtracts 0 * 0), and the padding
    stays zero (checked inside the model)."""
    D, U, b = (a.astype(np.float64) for a in _system(H, m, B, seed=m + 1))
    want = _bordered_sweep(D, U, b)
    got = _bordered_sweep(D, U, b, width=width, pivot_padding=pivot_padding)
    assert np.array_equal(got, want)
