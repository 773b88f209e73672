"""The port's point-cloud sphere SDF (the plain version of the CUDA kernel
in csrc/sphere_sdf.cu, and ``PointCloudSpheres``' routing) vs the JAX
package on the same numpy inputs, at tests/test_pallas_sdf.py's sizes.

Tolerances: 1e-5 against JAX's plain reference (float32 norms in another
order); 1e-4 against its Pallas kernel in interpret mode, as
tests/test_pallas_sdf.py holds that kernel (it expands |p|^2 + |c|^2 -
2 p.c, which cancels)."""
import re
from pathlib import Path

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


# ----------------------------------------------------------------------
# csrc/sphere_sdf.cu's scan, modelled in float32: the cull, the warps'
# split of the spheres and their shared minima, and the launch shape
# ----------------------------------------------------------------------
SDF_SOURCE = (Path(__file__).resolve().parents[1] / "torch_robotics_tpu_torch"
              / "csrc" / "sphere_sdf.cu")
F32 = torch.float32
MARGIN = torch.tensor(1.0 + 2.0 ** -20, dtype=F32)      # kMargin
TINY = torch.tensor(2.0 * torch.finfo(F32).tiny, dtype=F32)  # kTinyLimit
INF = float("inf")


def _source_int(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         SDF_SOURCE.read_text()).group(1))


def fma32(a, b, c):
    """float32 fma(a, b, c): a * b is exact in float64, then one rounding
    to float64 and one to float32 (the double rounding aside, the card's
    single rounding)."""
    return (a.double() * b.double() + c.double()).to(F32)


def model_d2(p, c):
    """The kernel's dx * dx + dy * dy + dz * dz, contracted as fma(dz, dz,
    fma(dx, dx, dy * dy)): p (M, 3), c (3,) -> (M,)."""
    d = p - c
    dx, dy, dz = d.unbind(-1)
    return fma32(dz, dz, fma32(dx, dx, dy * dy))


def cull_limit(best, rmax):
    """sphere_sdf.cu's cull_limit in float32."""
    b = best + rmax
    return torch.where(b > 0, torch.fmax(b * b * MARGIN, TINY),
                       torch.tensor(-1.0, dtype=F32))


def model_scan(p, c, r, warps, cull=True):
    """The kernel's values for points p (M, 3): each point's ``warps``
    warps split the spheres in stages of warps * 32 (padded with spheres
    at infinity of radius -inf), take their minima from the shared one at
    the start of a stage, take sqrtf(d2) - r only where d2 <= the cull
    limit (every pair without ``cull``) and push their minima to the
    shared one at the end of the stage.  -> (shared minima (M,), pairs
    evaluated, pairs within 4 ulps of their limit, (warp, sphere) steps
    that take the root: a block's 128 points a warp, the last block
    padded)."""
    M, S = p.shape[0], c.shape[0]
    per_stage = 32 * warps
    pad = -S % per_stage
    c = torch.cat([c, torch.full((pad, 3), INF, dtype=F32)])
    r = torch.cat([r, torch.full((pad,), -INF, dtype=F32)])
    shared = torch.full((M,), INF, dtype=F32)
    best = torch.full((warps, M), INF, dtype=F32)
    lim = torch.full((warps, M), INF, dtype=F32)
    evaluated = near = votes = 0
    for st in range(c.shape[0] // per_stage):
        rmax = [r[st * per_stage + 32 * w:][:32].max() for w in range(warps)]
        for w in range(warps):
            best[w] = torch.fmin(best[w], shared)
            if cull:
                lim[w] = cull_limit(best[w], rmax[w])
        for j in range(32):
            for w in range(warps):
                s = st * per_stage + 32 * w + j
                d2 = model_d2(p, c[s])
                hit = d2 <= lim[w]
                gap = (d2.view(torch.int32) - lim[w].view(torch.int32)).abs()
                near += int(((gap <= 4) & (lim[w] > 0)).sum())
                evaluated += int(hit.sum())
                votes += int(torch.nn.functional.pad(
                    hit, (0, -M % 128)).view(-1, 128).any(1).sum())
                best[w] = torch.where(hit, torch.fmin(
                    best[w], torch.sqrt(d2) - r[s]), best[w])
                if cull:
                    lim[w] = torch.where(hit, cull_limit(best[w], rmax[w]),
                                         lim[w])
        for w in range(warps):
            shared = torch.fmin(shared, best[w])
    return shared, evaluated, near, votes


def _adversarial(kind, seed):
    """(points, centers, radii) float32 that stress the cull."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, size=(96, 3)).astype(np.float32)
    if kind == "inside":       # radii 0.05-0.3: many points inside spheres
        c = rng.uniform(-1, 1, size=(300, 3))
        r = rng.uniform(0.05, 0.3, size=300)
    elif kind == "deep":       # large spheres first: best + r <= 0 after
        c = np.concatenate([p[:8] + 0.01, rng.uniform(-1, 1, size=(250,
                                                                   3))])
        r = np.concatenate([np.full(8, 1.4), rng.uniform(0.01, 0.05, 250)])
    elif kind == "equal":      # one radius, S = 129
        c = rng.uniform(-1, 1, size=(129, 3))
        r = np.full(129, 0.02)
    else:                      # "ties": spheres at +-ulps of each point's
        # win boundary, and duplicates of the base spheres
        c0 = rng.uniform(-1, 1, size=(128, 3)).astype(np.float32)
        r0 = rng.uniform(0.02, 0.1, size=128).astype(np.float32)
        base = model_scan(torch.as_tensor(p), torch.as_tensor(c0),
                          torch.as_tensor(r0), 4, cull=False)[0].numpy()
        rt = np.float32(0.05)
        dist = (base + rt).astype(np.float32)
        steps = np.arange(-4, 5, dtype=np.float32) * np.float32(2.0 ** -23)
        keep = dist > 0
        c_t = (p[keep, None, :] + (dist[keep, None] * (1 + steps))[..., None]
               * np.eye(3, dtype=np.float32)[rng.integers(0, 3, keep.sum())]
               [:, None, :]).reshape(-1, 3)
        n_t = -(-len(c_t) // 32) * 32
        c_t = np.concatenate([c_t, np.repeat(c_t[-1:], n_t - len(c_t), 0)])
        c = np.concatenate([c0, c0[:40], c_t])
        r = np.concatenate([r0, r0[:40], np.full(n_t - 8, rt)])
        r = np.concatenate([r, np.full(len(c) - len(r), rt)])
    return (torch.as_tensor(p), torch.as_tensor(c, dtype=F32),
            torch.as_tensor(r, dtype=F32))


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("kind", ["inside", "deep", "equal", "ties"])
def test_model_scan_cull_is_exact(kind, warps):
    """The cull changes no bit: the scan with it equals the scan without it
    (the plain min of each pair's expression) on inputs that stress it,
    and sphere_sdf_reference within 1e-6 (vector_norm may round the norm
    otherwise)."""
    p, c, r = _adversarial(kind, seed=len(kind) + warps)
    culled, evaluated, near, _ = model_scan(p, c, r, warps)
    full, all_pairs, _, _ = model_scan(p, c, r, warps, cull=False)
    plain = torch.stack([model_d2(p, c[s]).sqrt() - r[s]
                         for s in range(c.shape[0])]).amin(0)
    assert torch.equal(culled, full) and torch.equal(full, plain)
    assert evaluated < all_pairs
    if kind == "ties":
        assert near > 0
    if kind == "deep":
        assert bool((culled[:8] < -1.0).all())
    torch.testing.assert_close(culled, sdf_kernel.sphere_sdf_reference(
        p, c, r), rtol=0, atol=1e-6)


def test_cull_limit_keeps_every_winner():
    """Where fl(fl(sqrtf(d2)) - r) < best for some r <= rmax, d2 <=
    cull_limit(best, rmax): d2 over 64 ulps each side of the float nearest
    (best + rmax)^2, for (best, rmax) over 60 decades, both signs of best,
    best + rmax <= 0, a subnormal (best + rmax)^2 and an overflowing one."""
    rng = np.random.default_rng(5)
    mag = 10.0 ** rng.uniform(-30, 3, size=(2, 600))
    best = np.concatenate([mag[0], -mag[0] * rng.uniform(0, 1, 600),
                           [-0.3, -1e-20, 1e19, -0.05, 0.0]])
    rmax = np.concatenate([mag[1], mag[0] * rng.uniform(0, 2, 600),
                           [0.3, 2e-20, 1e19, 0.3, 1e-30]])
    best = torch.as_tensor(best, dtype=F32)[:, None]
    rmax = torch.as_tensor(rmax, dtype=F32)[:, None]
    b2 = ((best + rmax) ** 2).clamp(0, torch.finfo(F32).max)
    bits = b2.view(torch.int32) + torch.arange(-64, 65, dtype=torch.int32)
    d2 = bits.clamp_min(0).view(F32)
    lim = cull_limit(best, rmax)
    for r in (rmax, torch.nextafter(rmax, torch.zeros_like(rmax)),
              rmax * 0.5):
        wins = torch.sqrt(d2) - r < best
        assert bool((~wins | (d2 <= lim)).all())
    assert [float(x) for x in lim[-5:-2, 0]] == [-1.0, float(TINY), INF]


@pytest.mark.parametrize("M,S", [(65536, 4096), (65536, 129), (65536, 512),
                                 (65536, 16384), (65536, 4173), (1000, 4096),
                                 (1000, 129), (1, 1), (129, 32), (1 << 20,
                                                                   4096)])
def test_sdf_launch_config(M, S):
    """A block the card takes, a grid and stages that cover M and S, the
    source's shared memory; at M = 65,536 two blocks of eight warps on
    each of the 132 SMs."""
    cfg = sdf_kernel.sdf_launch_config(M, S)
    warps, tile = cfg["warps"], cfg["points_per_block"]
    assert tile == _source_int("kPoints") * 32
    assert _source_int("kPoints") <= warps <= _source_int("kMaxWarps")
    assert warps & (warps - 1) == 0 and cfg["threads"] == 32 * warps
    assert cfg["grid"] * tile >= M > (cfg["grid"] - 1) * tile
    per = cfg["threads"]
    assert cfg["stages"] * per >= S > (cfg["stages"] - 1) * per
    body = re.search(r"sdf_smem_bytes\(int warps\) \{\s*return (.*?);",
                     SDF_SOURCE.read_text(), re.S).group(1)
    assert cfg["smem_bytes"] == eval(body, {}, dict(
        warps=warps, kLanes=32, kTilePoints=tile)) <= 48 * 1024
    if M == 65536 and S >= 256:
        assert cfg["grid"] >= 2 * 132 and warps >= 8
    with pytest.raises(ValueError):
        sdf_kernel.sdf_launch_config(0, S)


if __name__ == "__main__":
    # the share of pairs, and of a warp's (sphere) steps, that take the
    # root in the model of the kernel's scan, on phase point_cloud's kind
    # of cloud (points and centers uniform in [-1, 1]^3, radius 0.02) at
    # M = 512 and its S = 4096, 8 warps a block as at M = 65,536
    rng = np.random.default_rng(12)
    p = torch.as_tensor(rng.uniform(-1, 1, size=(512, 3)), dtype=F32)
    c = torch.as_tensor(rng.uniform(-1, 1, size=(4096, 3)), dtype=F32)
    r = torch.full((4096,), 0.02)
    _, evaluated, _, votes = model_scan(p, c, r, 8)
    print("pairs evaluated %.4f, warp steps with a root %.4f"
          % (evaluated / (512 * 4096), votes / (512 // 128 * 4096)))
