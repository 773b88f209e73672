"""The column sweep's shared-memory route (``csrc/btridiag_cols_wide.cu``,
64 < m <= 128): its launch shape and routing on the host, a float64 torch
model of its order of operations, and the plain solve it is held to vs
the JAX package.

- ``cols_launch_config`` gives m in 65..128 the least padded width of 80,
  96, 112, 128 >= m, 512 threads, one lane a block and the source's
  shared memory (the packed bordered triangle at the width, where the
  backward pass's staging fits too, then a panel's 16 values a row and 4
  doubles), within the
  H100's 232,448 bytes; past 128 it raises in K4's words, and
  ``solve_lanes_auto`` on the card routes m <= 64 to the register route,
  65..128 to this one and raises past that.
- The model lays the bordered matrix's lower triangle out packed by
  columns, as the kernel does, and runs its order: pivots in panels of
  16, each panel column formed left-looking (its entries less the
  panel's earlier columns' products) and then scaled, then each trailing
  entry less the panel's 16 products summed apart; the trailing entries
  are numbered as the kernel's threads decode them (counted from the
  matrix's end, through a float32 square root), each taken once a panel.
  In float64 it solves the system (1e-10 of max|x| against the plain
  sweep and a dense solve), a real lane's x is the same bits at widths
  80 and 128, and the same bits again with the register route's padding
  rule (the matrix laid out at the width, its padded columns identity
  columns never pivoted, zero U rows and a zero right-hand side), which
  the kernel leaves out.
- The port's plain ``solve_lanes_core`` matches the JAX package's solve
  at (8, 70, 70, 4) in float64 to 1e-10 of max|x|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_btridiag import _dense_solve
from torch_robotics_tpu.solve.btridiag import \
    block_tridiag_solve as jax_block_tridiag_solve
from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
from torch_robotics_tpu_torch.solve.btridiag_lanes import solve_lanes_core

SMEM_MAX, THREADS, PANEL, TOL_F64 = 232448, 512, 16, 1e-10
WIDTHS = (80, 96, 112, 128)


def tri(n):
    return n * (n + 1) // 2


def col_base(c, n2):
    """Column c's row-0 offset in the packed triangle (the source's)."""
    return c * (2 * n2 - 1 - c) // 2


def _wide_system(H, m, B, seed):
    """A random SPD block-tridiagonal system at a wide m: D >= 3 I and
    |U| ~ 1, so the block system stays positive definite."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, H, m, m)) * 0.3 / np.sqrt(m / 14)
    D = np.transpose(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m),
                     (1, 2, 3, 0))
    U = rng.normal(size=(H, m, m, 1)) * (0.5 / np.sqrt(m))
    return [np.ascontiguousarray(a, dtype=np.float64)
            for a in (D, U, rng.normal(size=(H, m, B)))]


def trailing_entries(n2, count):
    """The kernel's numbering of a trailing triangle of ``count`` entries:
    entry u counted from the matrix's end, decoded through a float32
    square root and two integer fix-ups -> (r, c) of u = 0..count-1."""
    u = np.arange(count, dtype=np.int64)
    s = np.sqrt(np.float32(8.0) * u.astype(np.float32) + np.float32(1.0))
    q = ((s - np.float32(1.0)) * np.float32(0.5)).astype(np.int64)
    q += tri(q + 1) <= u
    q -= tri(q) > u
    return n2 - 1 - (u - tri(q)), n2 - 1 - q


def model_wide(D, U, b, width, padded=False):
    """float64 torch model of btridiag_cols_wide.cu, all lanes at once:
    per step the load phase (A = D_k + (-S), c = b_k + (-Wy), U_k^T, the
    trailing block cleared), then the pivots in panels of 16: column j
    formed left-looking (its rows less the panel's finished columns'
    products), its diagonal's square root and the rows below scaled by
    its reciprocal; after the panel every trailing entry (numbered as the
    kernel's threads decode them, each at most once: checked) less the
    panel's 16 products summed apart (zero past a short panel); the
    backward pass's x_k = L_k^-T (y_k - L_k^-1 (U_k x_{k+1})).
    ``padded`` lays the matrix out at ``width`` with the register route's
    padding instead of at m (``width`` sizes nothing else: the kernel's
    threads take the same entries at every width)."""
    H, m, _, B = D.shape
    w = width if padded else m
    n2 = 2 * w + 1
    D, U, b = (torch.as_tensor(a, dtype=torch.float64) for a in (D, U, b))
    M = torch.zeros((B, tri(n2)), dtype=torch.float64)
    rr, cc = np.tril_indices(m)
    ar = np.arange(m)
    a_idx = col_base(cc, n2) + rr
    c_idx = col_base(ar, n2) + 2 * w
    ut_c, ut_a = np.divmod(np.arange(m * m), m)
    ut_idx = col_base(ut_c, n2) + w + ut_a
    rows_t = np.append(np.arange(w, w + m), 2 * w)    # -S and -Wy rows
    tr_r, tr_c = np.tril_indices(m + 1)
    tr_idx = col_base(rows_t[tr_c], n2) + rows_t[tr_r]
    pad = np.arange(m, w)
    Ls, ys = [], []
    for k in range(H):
        if k > 0:
            Ls.append(M[:, a_idx].clone())
            ys.append(M[:, c_idx].clone())
        M[:, a_idx] = D[k][rr, cc].T + M[:, col_base(w + cc, n2) + w + rr]
        M[:, c_idx] = b[k].T + M[:, col_base(w + ar, n2) + 2 * w]
        M[:, ut_idx] = U[k, ut_c, ut_a, 0][None]
        M[:, tr_idx] = 0.0
        M[:, col_base(pad, n2) + pad] = 1.0
        for j0 in range(0, m, PANEL):
            j1 = min(j0 + PANEL, m)
            P = torch.zeros((B, n2, PANEL), dtype=torch.float64)
            for j in range(j0, j1):
                # column j, rows j.., less the panel's finished columns
                q0 = col_base(j, n2)
                v = M[:, q0 + j:q0 + n2].clone()
                for g in range(j - j0):             # in order, as the kernel
                    v -= P[:, j:, g] * P[:, j, g, None]
                p = torch.sqrt(v[:, 0])
                M[:, q0 + j] = p
                M[:, q0 + j + 1:q0 + n2] = v[:, 1:] * (1.0 / p)[:, None]
                P[:, j + 1:, j - j0] = M[:, q0 + j + 1:q0 + n2]
            r, c = trailing_entries(n2, tri(n2 - j1))
            e = col_base(c, n2) + r
            assert len(np.unique(e)) == len(e) and (c >= j1).all()
            q = [P[:, r, g] * P[:, c, g] for g in range(PANEL)]
            while len(q) > 1:                       # the kernel's tree
                q = [q[i] + q[i + 1] for i in range(0, len(q), 2)]
            M[:, e] -= q[0]
    Ls.append(M[:, a_idx].clone())
    ys.append(M[:, c_idx].clone())
    x = torch.zeros((H, m, B), dtype=torch.float64)
    x_next = None
    for k in reversed(range(H)):
        L = torch.zeros((B, m, m), dtype=torch.float64)
        L[:, rr, cc] = Ls[k]
        rhs = ys[k][..., None]
        if x_next is not None:
            v = U[k, :, :, 0] @ x_next
            rhs = rhs - torch.linalg.solve_triangular(L, v, upper=False)
        x_next = torch.linalg.solve_triangular(L.transpose(1, 2), rhs,
                                               upper=True)
        x[k] = x_next[..., 0].T
    return x.numpy()


@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("m", [65, 70, 84, 96, 112, 128])
def test_launch_config_past_64(m, B):
    cfg = bk.cols_launch_config(m, B)
    w = min(x for x in WIDTHS if x >= m)
    n2 = 2 * w + 1
    assert cfg["route"] == "shared" and cfg["width"] == w
    assert (cfg["threads"], cfg["lanes_per_block"], cfg["grid"]) == (
        THREADS, 1, B)
    assert 2 * w * (w + 1) + w <= tri(n2)         # the backward's staging
    assert cfg["smem_bytes"] == 4 * (-(-tri(n2) // 4) * 4 + PANEL * n2 + 8)
    assert cfg["smem_bytes"] <= SMEM_MAX
    if m <= 64 + 16:
        assert bk.cols_launch_config(64, B)["route"] == "registers"


def test_launch_config_refuses_past_128_in_k4_words():
    with pytest.raises(NotImplementedError, match=r"1 <= m <= 128, got 129"):
        bk.cols_launch_config(129, 4)
    assert bk.cols_launch_config(128, 4)["smem_bytes"] == 4 * 37276


@pytest.mark.parametrize("m,route", [(40, "_launch_cols"),
                                     (64, "_launch_cols"),
                                     (65, "_launch_cols_wide"),
                                     (70, "_launch_cols_wide"),
                                     (128, "_launch_cols_wide"),
                                     (129, None)])
def test_auto_routes_on_the_card(monkeypatch, m, route):
    """On the card (the device check made to say so, meta tensors), m <=
    64 takes the register route, 65..128 the shared-memory route in its
    width, past that NotImplementedError before any launch; the plain
    version never."""
    launched = []
    monkeypatch.setattr(bk, "_check_cuda", lambda *args: None)
    for name in ("_launch_cols", "_launch_cols_wide"):
        monkeypatch.setattr(bk, name, lambda *a, _n=name: launched.append(
            (_n, a[3])) or "x")
    monkeypatch.setattr(bk, "solve_lanes_core", None)
    D = torch.zeros((2, m, m, 3), device="meta")
    U = torch.zeros((2, m, m, 1), device="meta")
    b = torch.zeros((2, m, 3), device="meta")
    if route is None:
        with pytest.raises(NotImplementedError, match="m <= 128"):
            bk.solve_lanes_auto(D, U, b)
        assert not launched
        return
    assert bk.solve_lanes_auto(D, U, b) == "x"
    assert launched[0][0] == route
    if route == "_launch_cols_wide":
        assert launched[0][1] == bk.cols_launch_config(m, 3)["width"]
        with pytest.raises(NotImplementedError, match="register route"):
            bk.solve_lanes_cols(D, U, b)
    else:
        with pytest.raises(NotImplementedError, match="shared-memory"):
            bk.solve_lanes_cols_wide(D, U, b)


@pytest.mark.parametrize("m", [65, 70, 96, 128])
def test_trailing_numbering_takes_each_entry_once(m):
    """After every panel (j1 = 8, 16, ..., m) the kernel's numbering of
    the first T(n2 - j1) entries from the matrix's end is exactly the
    trailing lower triangle (c >= j1, r >= c), each entry once."""
    n2 = 2 * m + 1
    for j1 in list(range(PANEL, m, PANEL)) + [m]:
        r, c = trailing_entries(n2, tri(n2 - j1))
        want_r, want_c = np.tril_indices(n2 - j1)
        assert np.array_equal(np.sort(r * n2 + c), np.sort(
            (want_r + j1) * n2 + want_c + j1))


def test_model_solves_the_system_and_bits_ignore_the_width():
    D, U, b = _wide_system(3, 70, 2, seed=7)
    got = model_wide(D, U, b, 80)
    ref = solve_lanes_core(*map(torch.as_tensor, (D, U, b))).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_F64 * scale)
    np.testing.assert_allclose(got, _dense_solve(D, U, b), rtol=0,
                               atol=TOL_F64 * scale)
    assert np.array_equal(model_wide(D, U, b, 128), got)
    for w in (80, 128):
        assert np.array_equal(model_wide(D, U, b, w, padded=True), got)


def test_plain_solve_matches_jax_at_m70_in_float64():
    """At (8, 70, 70, 4): the JAX package's CPU route past m = 32, its
    tiled ``block_tridiag_solve``, which its GN step takes there (its
    ``solve_lanes_core`` compiles for ~40 s on the CPU at m = 70)."""
    D, U, b = _wide_system(8, 70, 4, seed=8)
    with jax.enable_x64(True):
        ref = np.asarray(jax_block_tridiag_solve(
            jnp.asarray(np.transpose(D, (3, 0, 1, 2))),
            jnp.asarray(U[:-1, :, :, 0]),
            jnp.asarray(np.transpose(b, (2, 0, 1)))))
    got = solve_lanes_core(*map(torch.as_tensor, (D, U, b))).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(np.transpose(got, (2, 0, 1)), ref, rtol=0,
                               atol=TOL_F64 * np.abs(ref).max())
