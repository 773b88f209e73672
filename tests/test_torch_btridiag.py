"""The port's block-tridiagonal solve (plain version of the CUDA sweep) vs
the JAX package's ``solve_lanes_core`` on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.solve.btridiag_lanes import \
    solve_lanes_core as jax_solve_lanes_core
from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
from torch_robotics_tpu_torch.solve.btridiag_lanes import solve_lanes_core


def _system(H, m, B, seed, per_batch_u=False):
    """Random well-conditioned SPD block-tridiagonal system in the lanes
    layout, built as tests/test_solve_btridiag.py::make_spd_btd does."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, H, m, m)) * 0.3
    D = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m)
    U = rng.normal(size=(H, m, m, B if per_batch_u else 1)) * 0.2
    b = rng.normal(size=(H, m, B))
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (np.transpose(D, (1, 2, 3, 0)), U, b)]


def _dense_solve(D, U, b):
    """float64 dense solve of one lanes-layout system per batch lane."""
    H, m, _, B = D.shape
    x = np.zeros((H, m, B))
    for k in range(B):
        A = np.zeros((H * m, H * m))
        for t in range(H):
            A[t * m:(t + 1) * m, t * m:(t + 1) * m] = D[t, :, :, k]
            if t + 1 < H:
                Ut = U[t, :, :, k if U.shape[-1] > 1 else 0]
                A[t * m:(t + 1) * m, (t + 1) * m:(t + 2) * m] = Ut
                A[(t + 1) * m:(t + 2) * m, t * m:(t + 1) * m] = Ut.T
        x[:, :, k] = np.linalg.solve(A, b[:, :, k].reshape(-1)).reshape(
            H, m)
    return x


@pytest.mark.parametrize("H,m,B", [(8, 14, 37), (5, 14, 1), (6, 4, 33)])
def test_solve_matches_jax(H, m, B):
    """B not a multiple of 32 (the CUDA sweep's ragged warp).  Float32 op
    order differs: rtol 1e-5 relative to max|x|."""
    D, U, b = _system(H, m, B, seed=H + m + B)
    ref = np.asarray(jax_solve_lanes_core(jnp.asarray(D), jnp.asarray(U),
                                          jnp.asarray(b)))
    got = solve_lanes_w(*map(torch.as_tensor, (D, U, b))).numpy()
    assert got.shape == (H, m, B)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(got, _dense_solve(D, U, b),
                               atol=1e-5 * np.abs(ref).max())


def test_plain_solve_takes_per_batch_u_like_jax():
    D, U, b = _system(4, 6, 9, seed=1, per_batch_u=True)
    ref = np.asarray(jax_solve_lanes_core(jnp.asarray(D), jnp.asarray(U),
                                          jnp.asarray(b)))
    got = solve_lanes_core(*map(torch.as_tensor, (D, U, b))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_wrapper_refuses_per_batch_u():
    """The sweep kernel reads U as blocks shared over the batch; a per-batch
    U would silently use one lane's blocks, so the wrapper refuses it."""
    D, U, b = _system(4, 6, 9, seed=2, per_batch_u=True)
    with pytest.raises(ValueError, match="per-batch U"):
        solve_lanes_w(*map(torch.as_tensor, (D, U, b)))


def test_wrapper_checks_shapes():
    D, U, b = map(torch.as_tensor, _system(4, 6, 9, seed=3))
    with pytest.raises(ValueError):
        solve_lanes_w(D, U, b[:, :, :5])
    with pytest.raises(ValueError):
        solve_lanes_w(D, U[:3], b)


def test_indefinite_pivot_gives_nan_like_the_reference():
    """No guard the reference lacks: a non-SPD block yields NaN."""
    D, U, b = _system(4, 6, 3, seed=4)
    D[1, :, :, 0] = -np.eye(6)
    ref = np.asarray(jax_solve_lanes_core(jnp.asarray(D), jnp.asarray(U),
                                          jnp.asarray(b)))
    got = solve_lanes_w(*map(torch.as_tensor, (D, U, b))).numpy()
    assert np.isnan(ref[:, :, 0]).any() and np.isnan(got[:, :, 0]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
