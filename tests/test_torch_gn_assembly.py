"""The port's GN assembly from materialized rows (plain version of the CUDA
kernel ``gn_assembly.cu``) vs the JAX package's ``gn_assembly_pallas`` in
interpret mode, on the same numpy (r, Jr).

Shape and tolerance: tests/test_pallas_terms.py's, P = 12, d = 5, N = 300
(a ragged last tile of 128), atol 1e-4 and rtol 1e-5; every d the kernel
is built for and ragged N against JAX's plain ``gn_assembly_reference``
(float32 sums in another order: 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.ops.pallas_gn_assembly import (
    gn_assembly_pallas, gn_assembly_reference as jax_gn_assembly_reference)
from torch_robotics_tpu.ops.pallas_gn_assembly import \
    triu_index_pairs as jax_triu_index_pairs
from torch_robotics_tpu_torch.ops.gn_assembly_kernel import (
    gn_assembly, gn_assembly_auto, gn_assembly_reference, triu_index_pairs)


def test_gn_assembly_matches_jax_kernel():
    rng = np.random.default_rng(0)
    P, d, N = 12, 5, 300
    r = rng.normal(size=(P, N)).astype(np.float32)
    Jr = rng.normal(size=(P, d, N)).astype(np.float32)
    ref = gn_assembly_pallas(jnp.asarray(r), jnp.asarray(Jr), tile_n=128,
                             interpret=True)
    got = gn_assembly(torch.as_tensor(r), torch.as_tensor(Jr))
    assert [tuple(g.shape) for g in got] == [(d, N), (d * (d + 1) // 2, N),
                                             (N,)]
    for g, x in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-4,
                                   rtol=1e-5)
    for g, x in zip(gn_assembly_auto(torch.as_tensor(r), torch.as_tensor(Jr)),
                    gn_assembly_reference(torch.as_tensor(r),
                                          torch.as_tensor(Jr))):
        assert torch.equal(g, x)


def test_row_order_and_shape_checks():
    assert triu_index_pairs(4) == jax_triu_index_pairs(4)
    with pytest.raises(ValueError):
        gn_assembly(torch.zeros((3, 5)), torch.zeros((3, 2, 4)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gn_assembly(torch.zeros((3, 5), device="meta"),
                    torch.zeros((3, 2, 5), device="meta"))


@pytest.mark.parametrize("N", [1, 37, 301])
@pytest.mark.parametrize("d", range(1, 9))
def test_every_d_and_ragged_n_match_jax(d, N):
    rng = np.random.default_rng(10 * d + N)
    P = 6
    r = rng.normal(size=(P, N)).astype(np.float32)
    Jr = rng.normal(size=(P, d, N)).astype(np.float32)
    got = gn_assembly(torch.as_tensor(r), torch.as_tensor(Jr))
    ref = jax_gn_assembly_reference(jnp.asarray(r), jnp.asarray(Jr))
    assert [tuple(g.shape) for g in got] == [(d, N), (d * (d + 1) // 2, N),
                                             (N,)]
    for g, x in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5)

