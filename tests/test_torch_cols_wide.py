"""The column sweep's shared-memory route (``csrc/btridiag_cols_wide.cu``,
64 < m <= 128): its launch shape and routing on the host, the layouts and
the trailing tiles' numbering it relies on, a float64 torch model of its
order of operations, and the plain solve it is held to vs the JAX
package.

- ``cols_launch_config`` gives m in 65..128 the least padded width of 80,
  96, 112, 128 >= m, one lane a block of 256 threads (512 where one lane
  fills an SM's shared memory) and the source's shared memory (the
  forward pass's packed bordered triangle, the panel's rows below it in
  double and its diagonal block, or the backward pass's buffers, the
  larger), within the H100's 232,448 bytes, and the blocks an SM (at
  most two); past 128 it raises in K4's words, and
  ``solve_lanes_auto`` on the card routes m <= 64 to the register route,
  65..128 to this one and raises past that.
- After each panel the kernel's 8 x 8 tiles (numbered by rows, decoded
  through a float32 square root) cover the trailing lower triangle, each
  entry once, split into contiguous runs a warp; warp 0's first three
  hold the next panel's diagonal block, which it factors while the others
  finish (look-ahead).  The panel's rows in double are laid out so that a
  tensor-core fragment and a warp's stores take no bank conflict.
- The model runs the kernel's order: pivots in panels of 16, each panel's
  diagonal block right-looking (reciprocal square roots), its rows below
  solved against it right-looking, the trailing entries less the panel's
  products in four steps of four columns; backward x_k = L_k^-T (y_k - W_k
  x_{k+1}) by columns with the kept reciprocals.  In float64 it solves the
  system (1e-10 of max|x| against the plain sweep, a dense solve and the
  JAX package's solve at m = 70 and 128), a real lane's x is the same
  bits at widths 80 and 128, and the same bits again with the register
  route's padding rule (the matrix laid out at the width, its padded
  columns identity columns never pivoted, zero U rows and a zero
  right-hand side), which the kernel leaves out.
- The port's plain ``solve_lanes_core`` matches the JAX package's solve
  at (8, 70, 70, 4) in float64 to 1e-10 of max|x|."""
import re
from pathlib import Path

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

SMEM_MAX, SM_SMEM, BLOCK_RESERVED = 232448, 233472, 1024
PANEL, TOL_F64 = 16, 1e-10
WIDTHS = (80, 96, 112, 128)
SOURCE = (Path(bk.__file__).resolve().parents[1] / "csrc"
          / "btridiag_cols_wide.cu").read_text()


def tri(n):
    return n * (n + 1) // 2


def round4(n):
    return -(-n // 4) * 4


def col_base(c, n2):
    """Column c's row-0 offset in the packed triangle (the source's)."""
    return c * (2 * n2 - 1 - c) // 2


def lcol(c, m):
    """Column c's offset in the scratch's L_k, packed by columns."""
    return c * (2 * m - c + 1) // 2


def pd_unit(row, u):
    """The source's place (in doubles) of the row's 16-byte unit u of the
    panel's rows below it."""
    return row * PANEL + 2 * (u ^ (row & 7))


def pd_place(row, k):
    """Entry (row, 4 kk + q): half kk % 2 of unit 2 q + kk // 2."""
    kk, q = divmod(k, 4)
    return pd_unit(row, 2 * q + kk // 2) + kk % 2


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


def tri_index(u):
    """The kernel's decoding of entry u of a triangle numbered by rows
    (float32 square root, two integer fix-ups) -> (I, J <= I)."""
    u = np.asarray(u, dtype=np.int64)
    s = np.sqrt(np.float32(8.0) * u.astype(np.float32) + np.float32(1.0))
    q = ((s - np.float32(1.0)) * np.float32(0.5)).astype(np.int64)
    q += tri(q + 1) <= u
    q -= tri(q) > u
    return q, u - tri(q)


def tile_entries(n2, j1, u):
    """The entries (r, c) relative to j1 that tile u's lanes read and
    write after the panel ending at j1 (mma's C layout: lane l holds
    (8 I + l / 4, 8 J + 2 (l % 4) + i)), masked as the kernel masks
    them."""
    nt = n2 - j1
    I, J = tri_index(u)
    g, q = np.divmod(np.arange(32), 4)
    r = np.repeat(8 * I + g, 2)
    c = (8 * J + 2 * q)[:, None] + np.arange(2)
    c = c.reshape(-1)
    ok = (r < nt) & (c <= r)
    return r[ok], c[ok]


def warp_runs(tiles, warps, ahead):
    """The kernel's split of the tiles into contiguous runs a warp: with a
    next panel (``ahead``) warp 0 takes the first three and the others the
    rest, else every warp a share."""
    if not ahead:
        return [(w * tiles // warps, (w + 1) * tiles // warps)
                for w in range(warps)]
    head = min(tiles, 3)
    rest = tiles - head
    return [(0, head)] + [(head + (w - 1) * rest // (warps - 1),
                           head + w * rest // (warps - 1))
                          for w in range(1, warps)]


def model_wide(D, U, b, width, padded=False):
    """float64 torch model of btridiag_cols_wide.cu, all lanes at once:
    per step the load (A = D_k + (-S), c = b_k + (-Wy), U_k^T, the
    trailing block cleared), then the pivots in panels of 16: the
    diagonal block right-looking (pivot j's reciprocal square root, the
    column scaled by it, each later column less its products), the rows
    below solved against it right-looking (scaled by the kept reciprocal,
    each later entry less its product), the trailing entries less the
    panel rows' products in steps of four columns; the backward pass's x_k
    = L_k^-T (y_k - W_k x_{k+1}), by columns from the last, each x_c its
    entry times the kept reciprocal.  ``padded`` lays the matrix out at
    ``width`` with the register route's padding instead of at m (``width``
    sizes nothing else: the kernel's entries see the same operations at
    every width and thread count)."""
    H, m, _, B = D.shape
    w = width if padded else m
    n2 = 2 * w + 1
    D, U, b = (torch.as_tensor(a, dtype=torch.float64) for a in (D, U, b))
    M = torch.zeros((B, n2, n2), dtype=torch.float64)
    F = torch.zeros((B, n2, m), dtype=torch.float64)   # factor columns
    Ls, Ws, ys = [], [], []
    for k in range(H):
        S = M[:, w:w + m, w:w + m].clone()               # -S
        Wy = M[:, 2 * w, w:w + m].clone()                # -Wy
        M.zero_()
        M[:, :m, :m] = D[k].permute(2, 0, 1) + S
        M[:, 2 * w, :m] = b[k].T + Wy
        M[:, w:w + m, :m] = U[k, :, :, 0].T
        M[:, m:w, m:w] = torch.eye(w - m, dtype=torch.float64)
        for j0 in range(0, m, PANEL):
            j1 = min(j0 + PANEL, m)
            wd = j1 - j0
            a = M[:, j0:j1, j0:j1].clone()
            for j in range(wd):
                inv = 1.0 / torch.sqrt(a[:, j, j])
                a[:, j + 1:, j] *= inv[:, None]
                a[:, j, j] = inv
                for c in range(j + 1, wd):
                    a[:, c:, c] -= a[:, c:, j] * a[:, c, j, None]
            R = M[:, j1:, j0:j1].clone()
            for j in range(wd):
                R[:, :, j] *= a[:, j, j, None]
                for c in range(j + 1, wd):
                    R[:, :, c] -= R[:, :, j] * a[:, c, j, None]
            F[:, j0:j1, j0:j1] = torch.tril(a)
            F[:, j1:, j0:j1] = R
            for g0 in range(0, wd, 4):                 # one mma step each
                for g in range(g0, min(g0 + 4, wd)):
                    M[:, j1:, j1:] -= R[:, :, g, None] * R[:, None, :, g]
        Ls.append(torch.tril(F[:, :m, :m]))
        Ws.append(F[:, w:w + m, :m].transpose(1, 2).clone())   # W_k[c][a]
        ys.append(F[:, 2 * w, :m].clone())
    x = torch.zeros((H, m, B), dtype=torch.float64)
    x_next = None
    for k in reversed(range(H)):
        r = ys[k].clone()
        if x_next is not None:
            r = r - (Ws[k] * x_next[:, None, :]).sum(-1)
        L = Ls[k]
        for c in reversed(range(m)):
            xc = r[:, c] * L[:, c, c]
            r[:, c] = xc
            r[:, :c] -= L[:, c, :c] * xc[:, None]
        x_next = r
        x[k] = r.T
    return x.numpy()


def _shared_bytes(w):
    """The source's WideShape<w>::kBytes, from its terms."""
    n2 = 2 * w + 1
    pd_rows = -(-(n2 - PANEL) // 8) * 8
    fwd = round4(tri(n2)) + 2 * PANEL * pd_rows + 2 * PANEL * PANEL
    bwd = 2 * round4(tri(w)) + (w + 1) * round4(w) + 4 * w
    return 4 * max(fwd, bwd)


@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("m", [65, 70, 84, 96, 112, 128])
def test_launch_config_past_64(m, B):
    cfg = bk.cols_launch_config(m, B)
    w = min(x for x in WIDTHS if x >= m)
    fit = SM_SMEM // (_shared_bytes(w) + BLOCK_RESERVED)
    assert cfg["route"] == "shared" and cfg["width"] == w
    assert (cfg["threads"], cfg["lanes_per_block"], cfg["grid"]) == (
        512 if fit == 1 else 256, 1, B)
    assert cfg["smem_bytes"] == _shared_bytes(w) <= SMEM_MAX
    assert fit == {80: 3, 96: 2}.get(w, 1)
    assert cfg["blocks_per_sm"] == min(fit, 2)
    assert cfg["step_floats"] == round4(tri(m)) + (m + 1) * round4(m)
    assert 132 * cfg["blocks_per_sm"] >= B or w > 96    # one wave
    if m <= 64 + 16:
        assert bk.cols_launch_config(64, B)["route"] == "registers"


def test_launch_config_refuses_past_128_in_k4_words():
    with pytest.raises(NotImplementedError, match=r"1 <= m <= 128, got 129"):
        bk.cols_launch_config(129, 4)
    assert bk.cols_launch_config(128, 4)["smem_bytes"] == 166416


def test_source_constants_match_the_host():
    """The host's copies of the source's panel, thread counts, widths and
    scratch layout."""
    assert "constexpr int kPanel = 16;" in SOURCE
    assert "constexpr int kMaxM = 128;" in SOURCE
    assert re.search(r"case 80: .*\n\s*case 96: .*\n\s*case 112: .*\n\s*"
                     r"case 128: ", SOURCE)
    assert "kThreads = kBlocksPerSM > 1 ? 256 : 512;" in SOURCE
    assert "return round4(tri(m)) + (m + 1) * round4(m);" in SOURCE
    assert "return row * kPanel + 2 * (u ^ (row & 7));" in SOURCE
    assert bk.cols_wide_step_floats(70) == round4(tri(70)) + 71 * 72


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


@pytest.mark.parametrize("warps", [8, 16])
@pytest.mark.parametrize("m", [65, 70, 96, 128])
def test_trailing_numbering_takes_each_entry_once(m, warps):
    """After every panel (j1 = 16, 32, ..., m) the kernel's tiles, decoded
    from u = 0..T(ceil((n2 - j1) / 8)) - 1 and masked as it masks them,
    cover the trailing lower triangle (c >= j1, r >= c, r < n2), each
    entry once; the warps' runs split the tiles without a gap, and with a
    next panel warp 0's run holds its whole diagonal block."""
    n2 = 2 * m + 1
    for j1 in list(range(PANEL, m, PANEL)) + [m]:
        nt = n2 - j1
        tiles = tri(-(-nt // 8))
        r, c = zip(*(tile_entries(n2, j1, u) for u in range(tiles)))
        r, c = np.concatenate(r), np.concatenate(c)
        want_r, want_c = np.tril_indices(nt)
        assert np.array_equal(np.sort(r * n2 + c),
                              np.sort(want_r * n2 + want_c))
        runs = warp_runs(tiles, warps, ahead=j1 < m)
        assert runs[0][0] == 0 and runs[-1][1] == tiles
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        if j1 < m:
            w2 = min(PANEL, m - j1)
            got = {(int(a), int(b)) for u in range(*runs[0])
                   for a, b in zip(*tile_entries(n2, j1, u))}
            assert {(a, b) for a in range(w2) for b in range(a + 1)} <= got


def test_panel_layout_takes_no_bank_conflict():
    """The panel's rows below it in double: every entry a place of its
    own; a lane's four entries of a tensor-core fragment (lane l: row 8 I
    + l / 4, columns 4 kk + l % 4) are two aligned 16-byte units, each
    quarter warp's loads of a unit hit 8 distinct 16-byte bank groups,
    and so do 8 consecutive rows' stores of one unit."""
    rows, k = np.meshgrid(np.arange(200), np.arange(PANEL), indexing="ij")
    flat = np.vectorize(pd_place)(rows, k)
    assert np.array_equal(np.sort(flat.reshape(-1)), np.arange(200 * PANEL))
    for l in range(32):
        g, q = divmod(l, 4)
        for h in range(2):
            unit = pd_unit(8 + g, 2 * q + h)
            assert unit % 2 == 0
            assert [pd_place(8 + g, 4 * kk + q) for kk in (2 * h, 2 * h + 1)
                    ] == [unit, unit + 1]
    for I in range(4):
        for h in range(2):
            groups = [(pd_unit(8 * I + l // 4, 2 * (l % 4) + h) // 2) % 8
                      for l in range(32)]
            for quarter in range(4):
                assert len(set(groups[8 * quarter:8 * quarter + 8])) == 8
    for row0 in range(0, 64, 8):
        for u in range(PANEL // 2):
            assert len({(pd_unit(row0 + t, u) // 2) % 8
                        for t in range(8)}) == 8


def test_scratch_layout_packs_each_step():
    """L_k packed by columns (column c's rows c..m-1 from lcol(c)), W_k's
    rows at a stride of round4(m), then y_k: every entry a place of its
    own, 16-byte aligned sections."""
    for m in (65, 70, 128):
        places = [lcol(c, m) + r - c for c in range(m) for r in range(c, m)]
        assert sorted(places) == list(range(tri(m)))
        ow, ldw = round4(tri(m)), round4(m)
        w_places = [ow + c * ldw + a for c in range(m) for a in range(m)]
        y = ow + m * ldw
        assert min(w_places) >= tri(m) and max(w_places) < y
        assert ow % 4 == 0 and y % 4 == 0
        assert y + ldw == bk.cols_wide_step_floats(m)


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


@pytest.mark.parametrize("m", [70, 128])
def test_model_matches_jax_in_float64(m):
    """The model at m = 70 and 128 (H = 3, B = 2) against the JAX
    package's solve in float64, to 1e-10 of max|x|: its tiled
    ``block_tridiag_solve``, the CPU route its GN step takes past m = 32
    (its lanes ``solve_lanes_core``, unrolled in m, takes one to several
    minutes to trace and compile or to run eagerly at these m on a
    CPU)."""
    D, U, b = _wide_system(3, m, 2, seed=m)
    with jax.enable_x64(True):
        ref = np.asarray(jax_block_tridiag_solve(
            jnp.asarray(np.transpose(D, (3, 0, 1, 2))),
            jnp.asarray(U[:-1, :, :, 0]),
            jnp.asarray(np.transpose(b, (2, 0, 1)))))
    got = model_wide(D, U, b, min(x for x in WIDTHS if x >= m))
    np.testing.assert_allclose(np.transpose(got, (2, 0, 1)), ref, rtol=0,
                               atol=TOL_F64 * np.abs(ref).max())


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
