"""The iLQR sweeps past eight joints (d = 9, 14, 20 and 35: the first joint
count of the shared route, the dual-arm TIAGo, config 4's three arms and
five Pandas) on the CPU, where the CUDA wrappers take their plain
versions: the port's plain sweep and rollout against the JAX package on
the same numpy inputs, and the kernel source's constants that the launch
shapes mirror (``ilqr_solve_sharded`` at d = 14 is in
tests/test_torch_ilqr_wide.py).

References: the JAX package's Pallas kernels in interpret mode cost
minutes past d = 9 on the CPU (the sweep at d = 9 already; the rollout 7
s at d = 9, 16 s at d = 14, 38 s at d = 20), so the sweep is held to the
batched-QR recursion of tests/test_pallas_riccati.py (``_qr_reference``,
jnp, float64) and the rollout to the Pallas kernel at d = 9 and to the
closed-loop rollout written in jnp at the others.  Tolerances as
tests/test_torch_riccati.py: float64 holds the algorithm (1e-9: op order
only), float32 the sweep's 10 x 1e-5 relative on the gains
(pallas_riccati.py:18-19) and the rollout's float32 rounding (1e-6)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_riccati import _qr_reference

from torch_robotics_tpu.ops.pallas_riccati import \
    linesearch_rollout_pallas_factory
from torch_robotics_tpu_torch.ops import riccati_kernel as rk
from torch_robotics_tpu_torch.solve.riccati_lanes import (
    linesearch_rollout_lanes, riccati_backward_lanes)

DT, R, MU, KG = 0.04, 1e-4, 1e-6, 1e4
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)
SWEEP_TOL, ROLLOUT_TOL, F64_TOL = 1e-5, 1e-6, 1e-9
WIDE = (9, 14, 20, 35)
T, B = 3, 4


def _rel(got, ref, tol, name):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()),
                               err_msg=name)


def _sweep_inputs(d, P, seed):
    rng = np.random.default_rng(seed)
    m = 2 * d
    return [rng.normal(size=s).astype(np.float32)
            for s in ((T, d, B), (T, m, B), (T, m, P, B), (m, B))]


@pytest.mark.parametrize("d", WIDE)
def test_plain_sweep_matches_jax_qr_reference(d):
    """The port's plain sweep in float64 and float32 vs the JAX package's
    batched-QR recursion in float64 on the same inputs; the CUDA wrapper
    on CPU tensors is the plain version bit for bit."""
    m, P = 2 * d, 5
    U, l, Fc, Vx0 = _sweep_inputs(d, P, seed=d)
    with jax.enable_x64(True):
        ks_j, Ks_j = _qr_reference(
            d, m, P, T, DT, R, MU, KG,
            jnp.asarray(U.transpose(0, 2, 1), jnp.float64),
            jnp.asarray(l.transpose(0, 2, 1), jnp.float64),
            jnp.asarray(Fc.transpose(0, 3, 2, 1), jnp.float64),
            jnp.asarray(Vx0.T, jnp.float64))
        ks_j, Ks_j = np.asarray(ks_j), np.asarray(Ks_j)  # (T, B, d(, m))
    plain = riccati_backward_lanes(d, m, P, T, DT, R, MU, KG)
    for dtype, tol in ((torch.float64, F64_TOL),
                       (torch.float32, 10 * SWEEP_TOL)):
        ks, Ks = plain(*[torch.as_tensor(a, dtype=dtype)
                         for a in (U, l, Fc, Vx0)])
        _rel(ks.permute(0, 2, 1).numpy(), ks_j, tol, "ks %s" % dtype)
        _rel(Ks.permute(0, 3, 1, 2).numpy(), Ks_j, tol, "Ks %s" % dtype)
    ins = [torch.as_tensor(a) for a in (U, l, Fc, Vx0)]
    sweep = rk.riccati_backward_kernel_factory(d, m, P, T, DT, R, MU, KG)
    for got, want in zip(sweep(*ins), plain(*ins)):
        assert torch.equal(got, want)


def _rollout_inputs(d, seed):
    rng = np.random.default_rng(seed)
    m = 2 * d
    return [rng.normal(size=(T + 1, m, B)).astype(np.float32),
            rng.normal(size=(T, d, B)).astype(np.float32),
            rng.normal(size=(T, d, B)).astype(np.float32),
            (0.1 * rng.normal(size=(T, d, m, B))).astype(np.float32)]


def _jnp_rollout(d, xs, U, ks, Ks):
    """The closed-loop rollout at every step size in matrix form (jnp):
    u = U + alpha k + K (x - xs), x' = Phi x + B u -> (A, T, m, B),
    (A, T, d, B)."""
    m = 2 * d
    eye = jnp.eye(d, dtype=xs.dtype)
    Phi = jnp.block([[eye, DT * eye], [jnp.zeros_like(eye), eye]])
    Bm = jnp.concatenate([0.5 * DT * DT * eye, DT * eye], axis=0)
    outs_x, outs_u = [], []
    for a in ALPHAS:
        x = xs[0]                                            # (m, B)
        row_x, row_u = [], []
        for t in range(T):
            u = U[t] + a * ks[t] + jnp.einsum("dmb,mb->db", Ks[t],
                                              x - xs[t])
            x = Phi @ x + Bm @ u
            row_x.append(x)
            row_u.append(u)
        outs_x.append(jnp.stack(row_x))
        outs_u.append(jnp.stack(row_u))
    assert outs_x[0].shape == (T, m, xs.shape[-1])
    return jnp.stack(outs_x), jnp.stack(outs_u)


@pytest.mark.parametrize("d", WIDE)
def test_plain_rollout_matches_jax(d):
    """The port's plain rollout vs the JAX package's Pallas kernel in
    interpret mode (d = 9) and the jnp matrix-form rollout (every d, in
    float64 and float32); the CUDA wrapper on CPU tensors is the plain
    version bit for bit."""
    m = 2 * d
    ins = _rollout_inputs(d, seed=100 + d)
    plain = linesearch_rollout_lanes(d, m, T, DT, ALPHAS)
    got = plain(*[torch.as_tensor(a) for a in ins])
    if d == 9:
        ref = linesearch_rollout_pallas_factory(d, m, T, DT, ALPHAS)(
            *[jnp.asarray(a) for a in ins], tile_b=B, interpret=True)
        for g, r, name in zip(got, ref, ("xs", "U")):
            _rel(g.numpy(), r, ROLLOUT_TOL, name + " vs Pallas")
    with jax.enable_x64(True):
        ref64 = _jnp_rollout(d, *[jnp.asarray(a, jnp.float64) for a in ins])
        ref64 = [np.asarray(r) for r in ref64]
    got64 = plain(*[torch.as_tensor(a, dtype=torch.float64) for a in ins])
    for g, g64, r, name in zip(got, got64, ref64, ("xs", "U")):
        _rel(g64.numpy(), r, F64_TOL, name + " float64")
        _rel(g.numpy(), r, ROLLOUT_TOL, name + " float32")
    roll = rk.linesearch_rollout_kernel_factory(d, m, T, DT, ALPHAS)
    for a, b in zip(roll(*[torch.as_tensor(a) for a in ins]), got):
        assert torch.equal(a, b)


def test_launch_shapes_mirror_the_source():
    """The constants and strides that ``riccati_launch_config`` and
    ``rollout_launch_config`` mirror, read from ``csrc/riccati.cu``."""
    src = (Path(rk.__file__).resolve().parents[1] / "csrc"
           / "riccati.cu").read_text()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1))

    assert const("kWideMaxDof") == rk.MAX_DOF == 64
    assert const("kWideMaxCompute") == rk._WIDE_MAX_COMPUTE
    assert const("kMaxCompute") == rk._MAX_COMPUTE
    assert const("kRollStages") == rk._ROLL_STAGES
    assert const("kMaxSmem") == rk._MAX_SMEM
    assert "n % 8 == 0 ? n + 4 : n" in src     # wide_stride
    assert ("(M + D) * wide_stride(M) + D * D + D * M + M + 3 * D"
            in src)                            # wide_lane_floats
    # 4 past a multiple of 8: a quarter warp's 16-byte loads of one row of
    # 8 columns fall in distinct banks
    for rows in range(1, 300):
        s = rk._wide_stride(rows)
        assert s >= rows and s % 8 == 4
        assert len({(c * s // 4) % 8 for c in range(8)}) == 8
