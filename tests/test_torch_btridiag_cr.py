"""The port's L-and-y sweep (``solve_lanes_sweep``, both backward tails)
and block cyclic reduction (``solve_lanes_cr`` and its plain version
``solve_lanes_bcr``) vs the JAX package's ``solve_lanes_pallas`` and
``solve_lanes_pallas_bcr`` in interpret mode, on the same numpy systems.

Shapes: tests/test_pallas_btridiag.py's, (H, m, B) = (8, 6, 256), (8, 4,
128) and (6, 5, 128), the last with H padded to a power of two.  Tolerance:
that test's, rtol 1e-4 and atol 1e-5 (float32 op order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.ops.pallas_btridiag import (solve_lanes_pallas,
                                                    solve_lanes_pallas_bcr)
from torch_robotics_tpu.solve.btridiag_bcr import \
    block_tridiag_solve_bcr as jax_block_tridiag_solve_bcr
from torch_robotics_tpu_torch.ops.btridiag_kernel import (solve_lanes_cr,
                                                          solve_lanes_sweep)
from torch_robotics_tpu_torch.solve import (block_tridiag_solve_bcr,
                                            solve_lanes_bcr)

SHAPES = [(8, 6, 256), (8, 4, 128), (6, 5, 128)]


def _system(H, m, B, seed):
    """A random well-conditioned SPD block-tridiagonal system in the lanes
    layout with U shared over the batch (the GP prior's structure)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, H, m, m)) * 0.3
    D = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m)
    U = rng.normal(size=(H, m, m, 1)) * 0.2
    b = rng.normal(size=(H, m, B))
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (np.transpose(D, (1, 2, 3, 0)), U, b)]


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("bwd_trsv", [False, True])
@pytest.mark.parametrize("H,m,B", SHAPES)
def test_sweep_matches_jax_kernel(H, m, B, bwd_trsv):
    D, U, b = _system(H, m, B, seed=H + m + B)
    ref = solve_lanes_pallas(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b),
                             tile_b=128, interpret=True, bwd_trsv=bwd_trsv)
    got = solve_lanes_sweep(*map(torch.as_tensor, (D, U, b)),
                            bwd_trsv=bwd_trsv)
    assert got.shape == (H, m, B)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("H,m,B", SHAPES)
def test_cyclic_reduction_matches_jax_kernel(H, m, B):
    D, U, b = _system(H, m, B, seed=2 * (H + m + B))
    ref = solve_lanes_pallas_bcr(jnp.asarray(D), jnp.asarray(U),
                                 jnp.asarray(b), tile_b=128, interpret=True)
    tD, tU, tb = map(torch.as_tensor, (D, U, b))
    got = solve_lanes_cr(tD, tU, tb)
    assert got.shape == (H, m, B)
    _close(got.numpy(), ref)
    # the wrapper's CPU route is the plain version itself
    assert torch.equal(got, solve_lanes_bcr(tD, tU, tb))


def test_batch_major_cyclic_reduction_matches_jax():
    """block_tridiag_solve_bcr: batch-major D (..., H, m, m), U (..., H-1,
    m, m), b (..., H, m), with a per-batch U and H = 5 padded to 8."""
    rng = np.random.default_rng(3)
    Bv, H, m = 3, 5, 4
    A = rng.normal(size=(Bv, H, m, m)) * 0.3
    D = (A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m)).astype(np.float32)
    U = (rng.normal(size=(Bv, H - 1, m, m)) * 0.2).astype(np.float32)
    b = rng.normal(size=(Bv, H, m)).astype(np.float32)
    ref = jax_block_tridiag_solve_bcr(jnp.asarray(D), jnp.asarray(U),
                                      jnp.asarray(b))
    got = block_tridiag_solve_bcr(*map(torch.as_tensor, (D, U, b)))
    _close(got.numpy(), ref)


def test_wrappers_check_shapes_and_u():
    D, U, b = map(torch.as_tensor, _system(4, 6, 9, seed=4))
    for solve in (solve_lanes_sweep, solve_lanes_cr):
        with pytest.raises(ValueError):
            solve(D, U, b[:, :, :5])
        with pytest.raises(ValueError, match="per-batch U"):
            solve(D, U.expand(4, 6, 6, 9).contiguous(), b)
