"""The port's plain iLQR sweeps (the plain versions of the CUDA Riccati
sweep and line-search rollout kernels) vs the JAX package's Pallas kernels
run in interpret mode, and vs the port's independent QR form, on the same
numpy inputs.

Interpret mode unrolls the whole sweep at trace time, so the JAX kernel is
run at its own test's shapes (tests/test_pallas_riccati.py: d = 3, m = 6,
P = 5, T = 6, B = 16) in its well-conditioned regime (kg = 1e4, r = 1e-4);
the iLQR path's d = 7 is held by the QR check below and by the ilqr_solve
parity tests (tests/test_torch_ilqr.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.ops.pallas_riccati import (
    linesearch_rollout_pallas_factory, riccati_backward_pallas_factory)
from torch_robotics_tpu_torch.ops.riccati_kernel import (
    linesearch_rollout_kernel_factory, riccati_backward_kernel_factory)
from torch_robotics_tpu_torch.solve.riccati_lanes import (
    linesearch_rollout_lanes, riccati_backward_lanes, riccati_backward_qr)

DT, R, MU, KG = 0.04, 1e-4, 1e-6, 1e4
# the TPU kernel's own parity with the lanes sweep (pallas_riccati.py:18-19):
# ~1e-5 relative on the gains, float32 sums in another order
SWEEP_TOL = 1e-5
# the rollout is a short chain of mat-vecs: float32 rounding only
ROLLOUT_TOL = 1e-6


def _sweep_inputs(d, m, P, T, B, seed):
    """Numpy draws in the lanes layout: U_t_l (T, d, B), l_l (T, m, B),
    Fc_l (T, m, P, B) column-major F, Vx0 (m, B)."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(T, d, B))
    l = rng.normal(size=(T, m, B))
    Fc = rng.normal(size=(T, m, P, B))
    Vx0 = rng.normal(size=(m, B))
    return [a.astype(np.float32) for a in (U, l, Fc, Vx0)]


def _assert_rel(got, ref, tol, name):
    """|got - ref| <= tol max|ref| + tol |ref| elementwise."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()),
                               err_msg=name)


def test_plain_sweep_matches_jax_kernel_interpret():
    d, m, P, T, B = 3, 6, 5, 6, 16
    ins = _sweep_inputs(d, m, P, T, B, seed=0)
    ks_j, Ks_j = riccati_backward_pallas_factory(d, m, P, T, DT, R, MU, KG)(
        *[jnp.asarray(a) for a in ins], tile_b=8, interpret=True)
    ks, Ks = riccati_backward_lanes(d, m, P, T, DT, R, MU, KG)(
        *[torch.as_tensor(a) for a in ins])
    _assert_rel(ks.numpy(), ks_j, SWEEP_TOL, "ks")
    _assert_rel(Ks.numpy(), Ks_j, SWEEP_TOL, "Ks")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_sweep_matches_qr_form_at_path_widths(dtype):
    """d = 7, m = 14, P = 27 (20 collision rows + 7 limit rows), T = 6:
    the two-phase Householder sweep vs a batched torch.linalg.qr of the
    whole stacked array per step.  k and K do not depend on the QR's row
    signs.  Float64 holds the algorithm (1e-9: op order only); float32
    holds it at the sweep's tolerance."""
    d, m, P, T, B = 7, 14, 27, 6, 16
    ins = [torch.as_tensor(a, dtype=dtype)
           for a in _sweep_inputs(d, m, P, T, B, seed=1)]
    U_t_l, l_l, Fc_l, Vx0 = ins
    ks, Ks = riccati_backward_lanes(d, m, P, T, DT, R, MU, KG)(*ins)
    ks_q, Ks_q = riccati_backward_qr(d, m, P, T, DT, R, MU, KG)(
        U_t_l.permute(0, 2, 1), l_l.permute(2, 0, 1),
        Fc_l.permute(3, 0, 2, 1), Vx0.T)
    tol = 1e-9 if dtype == torch.float64 else 10 * SWEEP_TOL
    _assert_rel(ks.permute(0, 2, 1).numpy(), ks_q.numpy(), tol, "ks")
    _assert_rel(Ks.permute(0, 3, 1, 2).numpy(), Ks_q.numpy(), tol, "Ks")


def test_plain_rollout_matches_jax_kernel_interpret():
    d, m, T, B = 3, 6, 7, 16
    alphas = (1.0, 0.5, 0.25, 0.1, 0.03)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(T + 1, m, B)).astype(np.float32)
    U = rng.normal(size=(T, d, B)).astype(np.float32)
    ks = rng.normal(size=(T, d, B)).astype(np.float32)
    Ks = (0.1 * rng.normal(size=(T, d, m, B))).astype(np.float32)
    xs_j, U_j = linesearch_rollout_pallas_factory(d, m, T, DT, alphas)(
        *[jnp.asarray(a) for a in (xs, U, ks, Ks)], tile_b=8,
        interpret=True)
    xs_p, U_p = linesearch_rollout_lanes(d, m, T, DT, alphas)(
        *[torch.as_tensor(a) for a in (xs, U, ks, Ks)])
    _assert_rel(xs_p.numpy(), xs_j, ROLLOUT_TOL, "xs")
    _assert_rel(U_p.numpy(), U_j, ROLLOUT_TOL, "U")


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors go to the plain versions, bit for bit; shapes that do
    not match the factory's are refused on every device."""
    d, m, P, T, B = 7, 14, 9, 4, 5
    ins = [torch.as_tensor(a) for a in _sweep_inputs(d, m, P, T, B, seed=3)]
    sweep = riccati_backward_kernel_factory(d, m, P, T, DT, R, MU, KG)
    for a, b in zip(sweep(*ins), sweep.plain(*ins)):
        assert torch.equal(a, b)
    ks, Ks = sweep(*ins)
    xs = torch.as_tensor(np.random.default_rng(4).normal(
        size=(T + 1, m, B)).astype(np.float32))
    roll = linesearch_rollout_kernel_factory(d, m, T, DT, (1.0, 0.5))
    for a, b in zip(roll(xs, ins[0], ks, Ks), roll.plain(xs, ins[0], ks, Ks)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sweep(ins[0], ins[1], ins[2][:, :, :-1], ins[3])
    with pytest.raises(ValueError):
        roll(xs[:-1], ins[0], ks, Ks)
