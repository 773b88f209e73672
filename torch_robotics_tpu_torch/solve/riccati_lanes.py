"""The iLQR sweeps in plain PyTorch, batch in the minor (lane) axis: the
plain versions of the CUDA Riccati sweep and line-search rollout kernels
(``ops/riccati_kernel.py``).

Counterparts of ``backward_lanes`` and ``forward_lanes`` in
torch_robotics_tpu/solve/ilqr.py, which are closures there; here they are
built by factories with the signatures of the TPU kernels' factories
(torch_robotics_tpu/ops/pallas_riccati.py), so that tests and the kernel
wrappers can call them.  The math is that of the reference, op for op:
the square-root Riccati recursion carries Vxx = S^T S and QR-factors, by a
two-phase Householder sweep, the stacked array
[[sqrt(r + mu) I, 0], [S B, S Phi], [0, F_t]] at every step.

``riccati_backward_qr`` is the reference's ``backward`` (its ``"qr"``
mode), lifted out the same way: the same recursion with a batched
``torch.linalg.qr`` per step, the independent form the sweeps are held to.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["riccati_backward_lanes", "linesearch_rollout_lanes",
           "riccati_backward_qr", "dynamics_mats"]


def dynamics_mats(d: int, dt: float, dtype, device):
    """Phi = [[I, dt I], [0, I]], B = [[dt^2/2 I], [dt I]]."""
    eye = torch.eye(d, dtype=dtype, device=device)
    zero = torch.zeros((d, d), dtype=dtype, device=device)
    Phi = torch.cat([torch.cat([eye, dt * eye], dim=-1),
                     torch.cat([zero, eye], dim=-1)], dim=-2)
    Bm = torch.cat([0.5 * dt * dt * eye, dt * eye], dim=-2)
    return Phi, Bm


def riccati_backward_qr(d: int, m: int, P: int, T: int, dt: float,
                        r: float, mu: float, kg: float):
    """sweep(U_t (T, B, d), l_xs (B, T, m), F (B, T, P, m), Vx0 (B, m))
    -> (ks (T, B, d), Ks (T, B, d, m)), batch-first and time-major as the
    reference's ``backward``.  Each step QR-factors the stacked array
    whole; k and K do not depend on the sign convention of the QR."""
    sqrt_ru = (r + mu) ** 0.5

    def sweep(U_t, l_xs, F, Vx0):
        B = Vx0.shape[0]
        kw = dict(dtype=Vx0.dtype, device=Vx0.device)
        Phi, Bm = dynamics_mats(d, dt, **kw)
        S = (kg ** 0.5 * torch.eye(m, **kw)).expand(B, m, m)
        top = torch.cat([sqrt_ru * torch.eye(d, **kw),
                         torch.zeros((d, m), **kw)], dim=-1).expand(
                             B, d, d + m)
        zeros_Pd = torch.zeros((B, P, d), **kw)
        Vx = Vx0
        ks, Ks = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            A = torch.cat([top, torch.cat([S @ Bm, S @ Phi], dim=-1),
                           torch.cat([zeros_Pd, F[:, t]], dim=-1)], dim=-2)
            R = torch.linalg.qr(A, mode="r")[1]
            R11, R12 = R[:, :d, :d], R[:, :d, d:]
            S = R[:, d:, d:]                                 # Vxx = S^T S
            Qx = l_xs[:, t] + Vx @ Phi                       # Phi^T Vx
            Qu = r * U_t[t] + Vx @ Bm                        # B^T Vx
            w = torch.linalg.solve_triangular(R11.transpose(-1, -2),
                                              Qu[..., None], upper=False)
            k = -torch.linalg.solve_triangular(R11, w, upper=True)[..., 0]
            K = -torch.linalg.solve_triangular(R11, R12, upper=True)
            # Vx_next = Qx + Qux^T k with Qux = R11^T R12
            Vx = Qx + torch.einsum("bdm,bd->bm", R12,
                                   (R11 @ k[..., None])[..., 0])
            ks[t], Ks[t] = k, K
        return torch.stack(ks), torch.stack(Ks)

    return sweep


def riccati_backward_lanes(d: int, m: int, P: int, T: int, dt: float,
                           r: float, mu: float, kg: float):
    """sweep(U_t_l (T, d, B), l_l (T, m, B), Fc_l (T, m, P, B) column-major
    F, Vx0 (m, B)) -> (ks (T, d, B), Ks (T, d, m, B))."""
    sqrt_ru = (r + mu) ** 0.5
    sqrt_kg = kg ** 0.5

    def sweep(U_t_l, l_l, Fc_l, Vx0):
        B = Vx0.shape[-1]
        kw = dict(dtype=Vx0.dtype, device=Vx0.device)
        F_l = Fc_l.permute(0, 2, 1, 3)                       # (T, P, m, B)
        eye = torch.eye(m, **kw)
        Vx = Vx0
        S = sqrt_kg * eye[:, :, None] + torch.zeros_like(Vx0)[None]
        ks, Ks = [None] * T, [None] * T

        def zeros(j):
            return torch.zeros((j, B), **kw)

        for t in range(T - 1, -1, -1):
            u, l_x, F_t = U_t_l[t], l_l[t], F_l[t]
            S1, S2 = S[:, :d], S[:, d:]
            G = 0.5 * dt * dt * S1 + dt * S2                 # S @ B (m, d, B)
            M = torch.cat([S1, dt * S1 + S2], dim=1)         # S @ Phi

            # phase 1: d reflections over the u-block columns
            r11_rows, r12_rows = [], []
            for j in range(d):
                g = G[:, 0]                                  # (m, B)
                gg = torch.sum(g * g, dim=0)
                alpha = -torch.sqrt(sqrt_ru * sqrt_ru + gg)
                v0 = sqrt_ru - alpha                         # > 0 always
                beta = 2.0 / (v0 * v0 + gg)
                W_x = torch.sum(g[:, None] * M, dim=0)       # (m, B)
                r12_rows.append(-(beta * v0) * W_x)
                M = M - (beta * W_x)[None] * g[:, None]
                if j < d - 1:
                    W_u = torch.sum(g[:, None] * G[:, 1:], dim=0)
                    r11_rows.append(torch.cat(
                        [zeros(j), alpha[None], -(beta * v0) * W_u]))
                    G = G[:, 1:] - (beta * W_u)[None] * g[:, None]
                else:
                    r11_rows.append(torch.cat([zeros(j), alpha[None]]))

            # phase 2: m reflections triangularize [M; F_t] -> S_next
            s_rows = []
            Fm = F_t
            for j in range(m):
                vm, vf = M[:, 0], Fm[:, 0]                   # (m-j, B), (P, B)
                head = vm[0]
                rest2 = (torch.sum(vm[1:] * vm[1:], dim=0)
                         + torch.sum(vf * vf, dim=0))
                norm = torch.sqrt(head * head + rest2)
                sign = torch.where(head >= 0, 1.0, -1.0).to(head.dtype)
                alpha = -sign * norm
                v0 = head - alpha
                vtv = v0 * v0 + rest2
                beta = torch.where(vtv > 0,
                                   2.0 / torch.where(vtv > 0, vtv, 1.0), 0.0)
                if j < m - 1:
                    v_m = torch.cat([v0[None], vm[1:]])
                    W = (torch.sum(v_m[:, None] * M[:, 1:], dim=0)
                         + torch.sum(vf[:, None] * Fm[:, 1:], dim=0))
                    Mr = M[:, 1:] - (beta * W)[None] * v_m[:, None]
                    Fm = Fm[:, 1:] - (beta * W)[None] * vf[:, None]
                    s_rows.append(torch.cat([zeros(j), alpha[None], Mr[0]]))
                    M = Mr[1:]
                else:
                    s_rows.append(torch.cat([zeros(j), alpha[None]]))
            S_new = torch.stack(s_rows)                      # (m, m, B)

            # Qx = l_x + Phi^T Vx, Qu = r u + B^T Vx (elementwise structure)
            Vq, Vv = Vx[:d], Vx[d:]
            Qx = torch.cat([l_x[:d] + Vq, l_x[d:] + dt * Vq + Vv])
            Qu = r * u + 0.5 * dt * dt * Vq + dt * Vv        # (d, B)

            R11 = r11_rows                                   # (d, B) rows
            R12 = torch.stack(r12_rows)                      # (d, m, B)
            # w = R11^{-T} Qu (forward subst), k = -R11^{-1} w (back subst)
            w_rows = []
            for i in range(d):
                acc = Qu[i]
                for l2 in range(i):
                    acc = acc - R11[l2][i] * w_rows[l2]
                w_rows.append(acc / R11[i][i])
            k_rows = [None] * d
            for i in range(d - 1, -1, -1):
                acc = -w_rows[i]
                for l2 in range(i + 1, d):
                    acc = acc - R11[i][l2] * k_rows[l2]
                k_rows[i] = acc / R11[i][i]
            # K = -R11^{-1} R12 (back substitution, m RHS columns at once)
            K_rows = [None] * d
            for i in range(d - 1, -1, -1):
                acc = -R12[i]
                for l2 in range(i + 1, d):
                    acc = acc - R11[i][l2][None] * K_rows[l2]
                K_rows[i] = acc / R11[i][i][None]
            # Vx_next = Qx + Qux^T k = Qx + R12^T (R11 k)
            Vx_new = Qx
            for i in range(d):
                y_i = R11[i][i] * k_rows[i]
                for l2 in range(i + 1, d):
                    y_i = y_i + R11[i][l2] * k_rows[l2]
                Vx_new = Vx_new + R12[i] * y_i[None]
            Vx, S = Vx_new, S_new
            ks[t], Ks[t] = torch.stack(k_rows), torch.stack(K_rows)
        return torch.stack(ks), torch.stack(Ks)

    return sweep


def linesearch_rollout_lanes(d: int, m: int, T: int, dt: float,
                             alphas: Sequence[float]):
    """rollout(xs_l (T + 1, m, B), U_t_l (T, d, B), ks (T, d, B),
    Ks (T, d, m, B)) -> (xs_new (A, T, m, B), U_new (A, T, d, B)): the
    closed-loop rollout at every step size, the states after step 0 (the
    caller prepends the shared first row)."""
    A = len(alphas)

    def rollout(xs_l, U_t_l, ks, Ks):
        a = torch.as_tensor(alphas, dtype=xs_l.dtype,
                            device=xs_l.device)[:, None, None]
        x = xs_l[0][None].expand(A, m, xs_l.shape[-1])
        xs_new, U_new = [], []
        for t in range(T):
            dx = x - xs_l[t][None]                            # (A, m, B)
            u = (U_t_l[t][None] + a * ks[t][None]
                 + torch.sum(Ks[t][None] * dx[:, None], dim=2))
            x = torch.cat([x[:, :d] + dt * x[:, d:] + 0.5 * dt * dt * u,
                           x[:, d:] + dt * u], dim=1)
            xs_new.append(x)
            U_new.append(u)
        return torch.stack(xs_new, dim=1), torch.stack(U_new, dim=1)

    return rollout
