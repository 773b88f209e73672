"""Batched block-tridiagonal SPD solver in the batch-major layout, plain
PyTorch (counterpart of torch_robotics_tpu/solve/btridiag.py, which is
plain XLA).

The system has H diagonal blocks D_t (m x m) coupled by upper
off-diagonal blocks U_t (block (t, t+1)).  The blocked Cholesky
A = L L^T (L block-bidiagonal: the Cholesky factors L_t of the running
Schur complements on its diagonal, W_t^T = (L_t^-1 U_t)^T below it) and
the two substitutions are Python loops over the horizon, each step one
batched ``torch.linalg`` call over every problem.  A pivot that is not
positive definite gives NaN factors, as the reference's Cholesky does
(``cholesky_ex``, which does not raise).  This is the solver CHOMP takes
for state blocks m > 32; smaller blocks take the lanes layout
(``block_tridiag_solve_lanes``).
"""
from __future__ import annotations

import torch

__all__ = ["block_tridiag_solve", "block_tridiag_cholesky",
           "block_tridiag_solve_factored", "block_tridiag_logdet"]


def _cholesky(A):
    """Lower Cholesky factor of a batch of SPD blocks; NaN where a block is
    not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _trsm_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _trsv(L, b, upper=False):
    """Solve L x = b (or L^T x = b with ``upper``, L lower) for b (..., m)."""
    A = L.transpose(-1, -2) if upper else L
    return torch.linalg.solve_triangular(A, b[..., None], upper=upper)[..., 0]


def _pad_U(U, batch, H, m):
    """U (..., H-1, m, m) with a zero block appended, broadcast to
    batch + (H, m, m) and flattened to (-1, H, m, m)."""
    U_pad = torch.cat([U, torch.zeros_like(U[..., :1, :, :])], dim=-3)
    return U_pad.expand(batch + (H, m, m)).reshape(-1, H, m, m)


def block_tridiag_cholesky(D, U):
    """Blocked LL^T factorization: D (..., H, m, m), U (..., H-1, m, m) ->
    (L_diag (..., H, m, m) lower Cholesky factors of the running Schur
    complements, L_off (..., H-1, m, m) the blocks below the diagonal), with
    A = L L^T.  U broadcasts against D's batch."""
    H, m = D.shape[-3], D.shape[-1]
    batch = D.shape[:-3]
    Df = D.reshape(-1, H, m, m)
    Uf = _pad_U(U, batch, H, m)
    S = torch.zeros_like(Df[:, 0])
    Ls, Los = [], []
    for t in range(H):
        L_t = _cholesky(Df[:, t] - S)
        W_t = _trsm_lower(L_t, Uf[:, t])          # W_t = L_t^-1 U_t
        S = W_t.transpose(-1, -2) @ W_t
        Ls.append(L_t)
        Los.append(W_t.transpose(-1, -2))
    L_diag = torch.stack(Ls, dim=1).reshape(batch + (H, m, m))
    L_off = torch.stack(Los, dim=1)[:, :H - 1].reshape(batch + (H - 1, m, m))
    return L_diag, L_off


def block_tridiag_solve_factored(L_diag, L_off, b):
    """Solve A x = b from ``block_tridiag_cholesky``'s factors: b (..., H,
    m) -> x (..., H, m).  Forward L y = b, then backward L^T x = y."""
    H, m = b.shape[-2], b.shape[-1]
    batch = b.shape[:-2]
    Ld = L_diag.reshape(-1, H, m, m)
    Lo = L_off.reshape(-1, H - 1, m, m)
    bf = b.reshape(-1, H, m)
    y = [None] * H
    y_prev = None
    for t in range(H):
        rhs = bf[:, t]
        if t:
            rhs = rhs - (Lo[:, t - 1] @ y_prev[..., None])[..., 0]
        y_prev = _trsv(Ld[:, t], rhs)
        y[t] = y_prev
    x = [None] * H
    x_next = None
    for t in reversed(range(H)):
        rhs = y[t]
        if t < H - 1:
            rhs = rhs - (Lo[:, t].transpose(-1, -2)
                         @ x_next[..., None])[..., 0]
        x_next = _trsv(Ld[:, t], rhs, upper=True)
        x[t] = x_next
    return torch.stack(x, dim=1).reshape(batch + (H, m))


def block_tridiag_solve(D, U, b):
    """Solve the block-tridiagonal SPD system A x = b.

    D (..., H, m, m), U (..., H-1, m, m), b (..., H, m); leading batch dims
    broadcast (e.g. a shared prior Hessian against a batch of right-hand
    sides).  One forward loop factors and substitutes together, one
    backward loop solves L^T x = y (the reference's ``_fused_solve_one``,
    batched)."""
    H, m = b.shape[-2], b.shape[-1]
    batch = torch.broadcast_shapes(D.shape[:-3], U.shape[:-3], b.shape[:-2])
    Df = D.expand(batch + (H, m, m)).reshape(-1, H, m, m)
    Uf = _pad_U(U, batch, H, m)
    bf = b.expand(batch + (H, m)).reshape(-1, H, m)
    S = torch.zeros_like(Df[:, 0])
    Wy = torch.zeros_like(bf[:, 0])
    Ls, Ws, ys = [], [], []
    for t in range(H):
        L_t = _cholesky(Df[:, t] - S)
        y_t = _trsv(L_t, bf[:, t] - Wy)
        W_t = _trsm_lower(L_t, Uf[:, t])
        S = W_t.transpose(-1, -2) @ W_t
        Wy = (W_t.transpose(-1, -2) @ y_t[..., None])[..., 0]
        Ls.append(L_t)
        Ws.append(W_t)
        ys.append(y_t)
    x = [None] * H
    x_next = torch.zeros_like(bf[:, 0])
    for t in reversed(range(H)):
        rhs = ys[t] - (Ws[t] @ x_next[..., None])[..., 0]
        x_next = _trsv(Ls[t], rhs, upper=True)
        x[t] = x_next
    return torch.stack(x, dim=1).reshape(batch + (H, m))


def block_tridiag_logdet(L_diag):
    """log |A| from the blocked Cholesky's diagonal factors (..., H, m, m)
    -> (...)."""
    diags = torch.diagonal(L_diag, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diags), dim=(-1, -2))
