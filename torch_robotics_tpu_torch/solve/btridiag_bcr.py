"""Block cyclic reduction: a log-depth block-tridiagonal SPD solve in plain
PyTorch (counterpart of torch_robotics_tpu/solve/btridiag_bcr.py, and the
plain version of the cyclic-reduction kernel ``csrc/btridiag_cr.cu``).

Each level eliminates the odd-indexed blocks of the remaining system in
parallel over blocks and lanes, halving it; back-substitution runs the
levels in reverse.  For the symmetric system
L_i x_{i-1} + D_i x_i + U_i x_{i+1} = b_i with L_i = U_{i-1}^T, odd
i = 2k+1, even j = 2k:

    A_k = D_i^-1 U_{i-1}^T,  C_k = D_i^-1 U_i,  beta_k = D_i^-1 b_i
    D'_k = D_j - U_{j-1}^T C_{k-1} - U_j A_k
    U'_k = -U_j C_k
    b'_k = b_j - U_{j-1}^T beta_{k-1} - U_j beta_k
    back-substitution: x_i = beta_k - A_k x_j - C_k x_{j+2}

H is padded to a power of two with decoupled identity blocks.
"""
from __future__ import annotations

import torch

from .btridiag_lanes import _chol_lanes, _trsm_lower_lanes

__all__ = ["block_tridiag_solve_bcr", "solve_lanes_bcr"]


def _mmT_left(A, B):
    """A^T @ B per block: (n, m, m, B) x (n, m, k, B) -> (n, m, k, B)."""
    return torch.einsum("npib,npjb->nijb", A, B)


def _mm(A, B):
    """A @ B per block: (n, m, m, B) x (n, m, k, B) -> (n, m, k, B)."""
    return torch.einsum("nipb,npjb->nijb", A, B)


def _mv(A, x):
    """A @ x per block: (n, m, m, B) x (n, m, B) -> (n, m, B)."""
    return torch.einsum("nipb,npb->nib", A, x)


def _mvT(A, x):
    """A^T @ x per block: (n, m, m, B) x (n, m, B) -> (n, m, B)."""
    return torch.einsum("npib,npb->nib", A, x)


def _trsm_upper(L, Bm):
    """Solve L^T X = Bm given lower L (m, m, K), Bm (m, k, K)."""
    m = Bm.shape[0]
    X = [None] * m
    for i in reversed(range(m)):
        s = Bm[i]
        for j in range(i + 1, m):
            s = s - L[j, i][None, :] * X[j]
        X[i] = s / L[i, i][None, :]
    return torch.stack(X)


def _block_solve(D, rhs):
    """Cholesky-solve D X = rhs per block: D (n, m, m, B) SPD, rhs (n, m,
    k, B) -> X of rhs's shape; blocks fold into the lane axis."""
    n, m, _, B = D.shape
    k = rhs.shape[2]
    Dm = D.permute(1, 2, 0, 3).reshape(m, m, n * B)
    Rm = rhs.permute(1, 2, 0, 3).reshape(m, k, n * B)
    L = _chol_lanes(Dm)
    X = _trsm_upper(L, _trsm_lower_lanes(L, Rm))
    return X.reshape(m, k, n, B).permute(2, 0, 1, 3)


def solve_lanes_bcr(Dt, Ut, bt):
    """Lane-layout cyclic-reduction solve: Dt (H, m, m, B), Ut (H, m, m, B
    or 1) coupling block i to i+1 (the last block unused), bt (H, m, B) ->
    x (H, m, B)."""
    H, m, _, B = Dt.shape
    kw = dict(dtype=Dt.dtype, device=Dt.device)
    H2 = 1
    while H2 < H:
        H2 *= 2
    pad = H2 - H
    if pad:
        eye = torch.eye(m, **kw)[None, :, :, None].expand(pad, m, m, B)
        Dt = torch.cat([Dt, eye], dim=0)
        bt = torch.cat([bt, torch.zeros((pad, m, B), **kw)], dim=0)
    # zero the coupling out of the original last block and the pads
    U = torch.cat([Ut.expand(H, m, m, B)[:H - 1],
                   torch.zeros((pad + 1, m, m, B), **kw)], dim=0)

    D, b = Dt, bt
    saved = []
    n = H2
    while n > 1:
        D_e, D_o = D[0::2], D[1::2]
        U_e, U_o = U[0::2], U[1::2]
        b_e, b_o = b[0::2], b[1::2]

        # [A | C | beta] = D_o^-1 [U_e^T | U_o | b_o]
        rhs = torch.cat([U_e.transpose(1, 2), U_o, b_o[:, :, None, :]],
                        dim=2)
        sol = _block_solve(D_o, rhs)
        A = sol[:, :, :m]
        C = sol[:, :, m:2 * m]
        beta = sol[:, :, 2 * m]

        # the odd block k-1's contributions to even block k (none for k = 0)
        UoT_C = _mmT_left(U_o, C)
        UoT_beta = _mvT(U_o, beta)
        D_new = (D_e - torch.cat([torch.zeros_like(UoT_C[:1]), UoT_C[:-1]])
                 - _mm(U_e, A))
        b_new = (b_e - torch.cat([torch.zeros_like(UoT_beta[:1]),
                                  UoT_beta[:-1]])
                 - _mv(U_e, beta))
        U_new = -_mm(U_e, C)
        # the last even block must not couple outward
        U = torch.cat([U_new[:-1], torch.zeros_like(U_new[:1])])
        saved.append((A, C, beta))
        D, b = D_new, b_new
        n //= 2

    x = _block_solve(D, b[:, :, None, :])[:, :, 0]          # (1, m, B)
    for A, C, beta in reversed(saved):
        n2 = A.shape[0]
        x_next = torch.cat([x[1:], torch.zeros_like(x[:1])])
        x_o = beta - _mv(A, x) - _mv(C, x_next)
        x = torch.stack([x, x_o], dim=1).reshape(2 * n2, m, B)
    return x[:H]


def block_tridiag_solve_bcr(D, U, b):
    """Batch-major form: D (..., H, m, m), U (..., H-1, m, m), b (..., H, m)
    -> x (..., H, m)."""
    H, m = b.shape[-2], b.shape[-1]
    batch = torch.broadcast_shapes(D.shape[:-3], U.shape[:-3], b.shape[:-2])
    Bv = 1
    for s in batch:
        Bv *= s
    D = D.expand(batch + (H, m, m)).reshape(Bv, H, m, m)
    U_pad = torch.cat([U, torch.zeros_like(U[..., :1, :, :])], dim=-3)
    U_pad = U_pad.expand(batch + (H, m, m)).reshape(Bv, H, m, m)
    b_flat = b.expand(batch + (H, m)).reshape(Bv, H, m)
    x = solve_lanes_bcr(D.permute(1, 2, 3, 0), U_pad.permute(1, 2, 3, 0),
                        b_flat.permute(1, 2, 0))
    return x.permute(2, 0, 1).reshape(batch + (H, m))
