"""Batch-minor block-tridiagonal SPD solve in plain PyTorch (counterpart of
torch_robotics_tpu/solve/btridiag_lanes.py::solve_lanes_core).

This is the plain version of the CUDA sweeps (``ops/btridiag_kernel.py``):
the same block Cholesky recursion as a Python loop over the horizon, with
every block entry a (B,) vector.  Indefinite pivots give NaN (no guard),
as in the reference.  ``solve_lanes_factor_core`` also returns the factors
(L, W) that the factor-persisting sweep writes, and
``solve_lanes_subst_core`` re-solves from them with a fresh right-hand
side (the math of torch_robotics_tpu/ops/pallas_btridiag.py's
``_kernel_factor`` and ``_kernel_subst`` with ``_bwd_subst_loop``).
``block_tridiag_solve_lanes`` takes the batch-major operands of
``solve/btridiag.block_tridiag_solve`` and solves them in this layout.
"""
from __future__ import annotations

import torch

__all__ = ["solve_lanes_core", "solve_lanes_factor_core",
           "solve_lanes_subst_core", "block_tridiag_solve_lanes"]


def _chol_lanes(A):
    """Cholesky of (m, m, B): lower L with L L^T = A, column by column."""
    m = A.shape[0]
    L = torch.zeros_like(A)
    for j in range(m):
        s = A[j, j] - torch.sum(L[j, :j] * L[j, :j], dim=0)
        L[j, j] = torch.sqrt(s)
        if j + 1 < m:
            t = A[j + 1:, j] - torch.sum(L[j + 1:, :j] * L[j, :j][None],
                                         dim=1)
            L[j + 1:, j] = t / L[j, j]
    return L


def _trsm_lower_lanes(L, Bm):
    """Solve L X = Bm, L lower (m, m, B), Bm (m, n, B or 1)."""
    m = L.shape[0]
    X = torch.zeros(torch.broadcast_shapes(Bm.shape, (m, 1, L.shape[-1])),
                    dtype=L.dtype, device=L.device)
    for i in range(m):
        s = Bm[i] - torch.sum(L[i, :i, None, :] * X[:i], dim=0)
        X[i] = s / L[i, i][None, :]
    return X


def _trsv_lower_lanes(L, b):
    """Solve L x = b, L lower (m, m, B), b (m, B)."""
    m = b.shape[0]
    x = torch.zeros_like(b)
    for i in range(m):
        x[i] = (b[i] - torch.sum(L[i, :i] * x[:i], dim=0)) / L[i, i]
    return x


def _trsv_upper_lanes(L, b):
    """Solve L^T x = b given lower L (m, m, B), b (m, B)."""
    m = b.shape[0]
    x = torch.zeros_like(b)
    for i in reversed(range(m)):
        x[i] = (b[i] - torch.sum(L[i + 1:, i] * x[i + 1:], dim=0)) / L[i, i]
    return x


def _forward_factor(Dt, Ut, bt):
    """Forward sweep: per block k, L_k = chol(D_k - W_{k-1}^T W_{k-1}),
    y_k = L_k^-1 (b_k - W_{k-1}^T y_{k-1}), W_k = L_k^-1 U_k -> lists of
    L_k (m, m, B), y_k (m, B), W_k (m, m, B)."""
    H = Dt.shape[0]
    S = torch.zeros_like(Dt[0])
    Wy = torch.zeros_like(bt[0])
    Ls, ys, Ws = [], [], []
    for k in range(H):
        L_k = _chol_lanes(Dt[k] - S)
        y_k = _trsv_lower_lanes(L_k, bt[k] - Wy)
        W_k = _trsm_lower_lanes(L_k, Ut[k])
        S = torch.sum(W_k[:, :, None, :] * W_k[:, None, :, :], dim=0)
        Wy = torch.sum(W_k * y_k[:, None, :], dim=0)
        Ls.append(L_k)
        ys.append(y_k)
        Ws.append(W_k)
    return Ls, ys, Ws


def _backward(Ls, ys, Ws):
    """x_{H-1} = L^-T y_{H-1}; x_k = L_k^-T (y_k - W_k x_{k+1})."""
    H = len(ys)
    x = [None] * H
    x_next = None
    for k in reversed(range(H)):
        rhs = ys[k]
        if x_next is not None:
            rhs = rhs - torch.sum(Ws[k] * x_next[None, :, :], dim=1)
        x_next = _trsv_upper_lanes(Ls[k], rhs)
        x[k] = x_next
    return torch.stack(x)


def solve_lanes_core(Dt, Ut, bt):
    """Lane-layout block-tridiagonal solve: Dt (H, m, m, B), Ut (H, m, m, B
    or 1) with the last block unused, bt (H, m, B) -> x (H, m, B)."""
    return _backward(*_forward_factor(Dt, Ut, bt))


def solve_lanes_factor_core(Dt, Ut, bt):
    """The solve of ``solve_lanes_core`` that also returns its factors:
    -> (x (H, m, B), L (H, m, m, B) lower with a zero strict upper
    triangle, W_k = L_k^-1 U_k (H, m, m, B))."""
    Ls, ys, Ws = _forward_factor(Dt, Ut, bt)
    return _backward(Ls, ys, Ws), torch.stack(Ls), torch.stack(Ws)


def solve_lanes_subst_core(L, W, bt):
    """Substitution-only re-solve of the factored system with a fresh
    right-hand side: L, W (H, m, m, B) from ``solve_lanes_factor_core``,
    bt (H, m, B) -> x (H, m, B).  Forward y_k = L_k^-1 (b_k - W_{k-1}^T
    y_{k-1}), then the factor sweep's backward pass."""
    Wy = torch.zeros_like(bt[0])
    ys = []
    for k in range(bt.shape[0]):
        y_k = _trsv_lower_lanes(L[k], bt[k] - Wy)
        Wy = torch.sum(W[k] * y_k[:, None, :], dim=0)
        ys.append(y_k)
    return _backward(L, ys, W)


def block_tridiag_solve_lanes(D, U, b):
    """Solve the block-tridiagonal SPD system A x = b in the lanes layout.

    Same semantics as ``btridiag.block_tridiag_solve``: D (..., H, m, m),
    U (..., H-1, m, m), b (..., H, m) with broadcastable batch dims.  The
    operands go to (H, m, m, B) with the batch in the last axis; a D or U
    shared by the whole batch is broadcast (U stays one shared (H, m, m, 1)
    block set, which the sweep reads for every lane)."""
    H, m = b.shape[-2], b.shape[-1]
    batch = torch.broadcast_shapes(D.shape[:-3], U.shape[:-3], b.shape[:-2])
    Bv = 1
    for s in batch:
        Bv *= s
    Dt = D.expand(batch + (H, m, m)).reshape(Bv, H, m, m).permute(1, 2, 3, 0)
    U_pad = torch.cat([U, torch.zeros_like(U[..., :1, :, :])], dim=-3)
    if U.dim() == 3:
        Ut = U_pad[..., None]                               # (H, m, m, 1)
    else:
        Ut = U_pad.expand(batch + (H, m, m)).reshape(
            Bv, H, m, m).permute(1, 2, 3, 0)
    bt = b.expand(batch + (H, m)).reshape(Bv, H, m).permute(1, 2, 0)
    x = solve_lanes_core(Dt, Ut, bt)                        # (H, m, B)
    return x.permute(2, 0, 1).reshape(batch + (H, m))
