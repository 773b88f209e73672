"""The port's point-cloud sphere SDF (the plain version of the CUDA kernel
in csrc/sphere_sdf.cu, and ``PointCloudSpheres``' routing) vs the JAX
package on the same numpy inputs, at tests/test_pallas_sdf.py's sizes.

Tolerances: 1e-5 against JAX's plain reference (float32 norms in another
order); 1e-4 against its Pallas kernel in interpret mode, as
tests/test_pallas_sdf.py holds that kernel (it expands |p|^2 + |c|^2 -
2 p.c, which cancels)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.geom import PointCloudSpheres as JPointCloudSpheres
from torch_robotics_tpu.ops.pallas_sdf import (sphere_sdf_pallas,
                                               sphere_sdf_reference)
from torch_robotics_tpu_torch.geom import PointCloudSpheres
from torch_robotics_tpu_torch.ops import sdf_kernel


def _cloud(M, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(M, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(S, 3)).astype(np.float32),
            rng.uniform(0.05, 0.3, size=(S,)).astype(np.float32))


@pytest.mark.parametrize("M,S", [(100, 10), (512, 128), (1000, 300)])
def test_plain_sdf_matches_jax(M, S):
    p, c, r = _cloud(M, S, seed=M + S)
    got = sdf_kernel.sphere_sdf_kernel(*map(torch.as_tensor, (p, c, r)))
    assert got.shape == (M,) and got.dtype == torch.float32
    ref = np.asarray(sphere_sdf_reference(*map(jnp.asarray, (p, c, r))))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    pal = np.asarray(sphere_sdf_pallas(*map(jnp.asarray, (p, c, r)),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), pal, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, sdf_kernel.sphere_sdf_reference(
        *map(torch.as_tensor, (p, c, r))))


def test_point_cloud_matches_jax_on_batched_queries():
    _, c, _ = _cloud(1, 400, seed=1)
    x = np.random.default_rng(2).uniform(-1.2, 1.2, size=(4, 6, 3)).astype(
        np.float32)
    got = PointCloudSpheres.create(c, radius=0.05, device="cpu")
    ref = JPointCloudSpheres.create(jnp.asarray(c), radius=0.05)
    assert got.dim == 3 and got.radii.shape == (400,)
    np.testing.assert_allclose(
        got.signed_distance(torch.as_tensor(x)).numpy(),
        np.asarray(ref.signed_distance(jnp.asarray(x))), atol=1e-5)
    assert got.compute_signed_distance(torch.as_tensor(x)).shape == (4, 6)


def test_routing(monkeypatch):
    """The kernel's wrapper is called for use_pallas, S >= 128 and 3-D
    points, as the reference routes to its kernel; on a CPU tensor the
    wrapper takes the plain version and launches nothing."""
    calls = []
    real = sdf_kernel.sphere_sdf_kernel

    def spy(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    monkeypatch.setattr(sdf_kernel, "sphere_sdf_kernel", spy)
    x = torch.as_tensor(_cloud(50, 1, seed=3)[0])
    launches = sdf_kernel.KERNEL.launches
    for S, use, routed in ((128, True, True), (127, True, False),
                           (300, False, False)):
        c = _cloud(1, S, seed=S)[1]
        cloud = PointCloudSpheres.create(c, radius=0.02, use_pallas=use,
                                         device="cpu")
        before = len(calls)
        out = cloud.signed_distance(x)
        assert (len(calls) > before) == routed, (S, use)
        ref = sdf_kernel.sphere_sdf_reference(x, cloud.centers, cloud.radii)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    assert sdf_kernel.KERNEL.launches == launches


def test_wrapper_refuses_bad_inputs():
    p, c, r = map(torch.as_tensor, _cloud(8, 4, seed=4))
    with pytest.raises(ValueError):
        sdf_kernel.sphere_sdf_kernel(p[:, :2], c, r)
    with pytest.raises(ValueError):
        sdf_kernel.sphere_sdf_kernel(p, c, r[:3])
    with pytest.raises(ValueError):
        sdf_kernel.sphere_sdf_kernel(p, c[:0], r[:0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sdf_kernel.sphere_sdf_kernel(*(t.to("meta") for t in (p, c, r)))
