"""The port's frames and manifolds (``core/frame.py``, ``core/euclidean.py``,
``core/manifold.py``, ``trajectory/manifold_ops.py``) against the JAX
package, on the arrays of tests/test_core_frame_manifold.py:11-64 and
tests/test_fk_velocities_manifold_ops.py:32-43 (and seeded numpy arrays
where those draw with jax.random):

- ``Frame`` / ``MotionVec``: every method against the JAX class's on the
  same float32 arrays, to 1e-5 of max(1, max|ref|), and the JAX tests'
  assertions;
- ``Manifold``: log / exp / transport of R^2 x S^3 and R^3 x S^3, the
  Karcher mean, the Gaussian's pdf, sample (the same normals z on both
  sides), transform and product and the KL divergence, to 1e-5
  (1e-4 through arccos near the identity);
- the trajectory velocity, derivatives and smoothing on R^2 and on an S^3
  x R^3 batch (2, 12, 7), to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.core import Frame as JFrame
from torch_robotics_tpu.core import MotionVec as JMotionVec
from torch_robotics_tpu.core import manifold as jman
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.trajectory import manifold_ops as jops
from torch_robotics_tpu_torch.core import Frame, MotionVec, z_rot
from torch_robotics_tpu_torch.core import manifold as pman
from torch_robotics_tpu_torch.core.euclidean import (e_exp_map, e_log_map,
                                                     e_parallel_transport)
from torch_robotics_tpu_torch.core.quaternion import q_exp_map
from torch_robotics_tpu_torch.trajectory import manifold_ops as pops

TOL = 1e-5


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


def j(a):
    return jnp.asarray(np.array(a, np.float32))


RNG = np.random.default_rng(0)
ANG = RNG.uniform(-1, 1, (4,)).astype(np.float32)
TR = RNG.normal(size=(4, 3)).astype(np.float32)
ANG2 = RNG.uniform(-1, 1, (4,)).astype(np.float32)
TR2 = RNG.normal(size=(4, 3)).astype(np.float32)
PTS = RNG.normal(size=(4, 5, 3)).astype(np.float32)


def frames():
    return (Frame(z_rot(t(ANG)), t(TR)), Frame(z_rot(t(ANG2)), t(TR2)),
            JFrame(jz_rot(j(ANG)), j(TR)), JFrame(jz_rot(j(ANG2)), j(TR2)))


def test_frame_methods_match_jax():
    f, g, jf, jg = frames()
    close(f.multiply_transform(g).rot, jf.multiply_transform(jg).rot)
    close(f.multiply_transform(g).trans, jf.multiply_transform(jg).trans)
    close(f.inverse().rot, jf.inverse().rot)
    close(f.inverse().trans, jf.inverse().trans)
    close(f.get_transform_matrix(), jf.get_transform_matrix())
    close(f.get_quaternion(), jf.get_quaternion())
    close(f.get_quaternion(wxyz=True), jf.get_quaternion(wxyz=True))
    close(f.transform_point(t(PTS)), jf.transform_point(j(PTS)))
    close(f.trans_cross_rot(), jf.trans_cross_rot())
    for a, b in zip(f.get_euler(), jf.get_euler()):
        close(a, b)
    assert f.rotation is f.rot and f.translation is f.trans
    pose = np.float32([1.0, 2.0, 3.0, 0.9, 0.1, -0.3, 0.2])
    close(Frame.from_pose(t(pose)).rot, JFrame.from_pose(j(pose)).rot)
    close(Frame.from_pose(t(pose)).trans, JFrame.from_pose(j(pose)).trans)


def test_frame_assertions_of_the_jax_tests():
    """tests/test_core_frame_manifold.py:11-46 on the port."""
    f = Frame.identity((4,), device="cpu")
    close(f.get_transform_matrix(), np.tile(np.eye(4), (4, 1, 1)), 0.0)
    g = Frame(z_rot(torch.full((4,), 0.5)), torch.ones(4, 3))
    prod = g.multiply_transform(g.inverse())
    close(prod.rot, np.tile(np.eye(3), (4, 1, 1)), 1e-6)
    close(prod.trans, np.zeros((4, 3)), 1e-6)
    f0 = Frame.identity(device="cpu")
    close(f0.get_quaternion(), [0, 0, 0, 1.0], 1e-6)
    close(f0.get_quaternion(wxyz=True), [1.0, 0, 0, 0], 1e-6)
    f1 = Frame.from_pose(torch.tensor([1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0]))
    close(f1.transform_point(torch.tensor([[1.0, 0.0, 0.0]])),
          [[2.0, 2.0, 3.0]], 1e-6)
    mv = MotionVec(torch.tensor([1.0, 0, 0]), torch.tensor([0.0, 0, 1.0]))
    out = mv.transform(Frame(z_rot(torch.tensor(np.pi / 2)), torch.zeros(3)))
    close(out.ang, [0, 0, 1.0], 1e-6)
    close(out.lin, [0, 1.0, 0], 1e-6)


def test_motion_vec_methods_match_jax():
    f, _, jf, _ = frames()
    a = RNG.normal(size=(4, 4, 3)).astype(np.float32)
    mv, mw = MotionVec(t(a[0]), t(a[1])), MotionVec(t(a[2]), t(a[3]))
    jv, jw = JMotionVec(j(a[0]), j(a[1])), JMotionVec(j(a[2]), j(a[3]))
    for got, ref in ((mv.add_motion_vec(mw), jv.add_motion_vec(jw)),
                     (mv.cross_motion_vec(mw), jv.cross_motion_vec(jw)),
                     (mv.transform(f), jv.transform(jf))):
        close(got.lin, ref.lin)
        close(got.ang, ref.ang)
    close(mv.get_vector(), jv.get_vector())
    close(mv.dot(mw), jv.dot(jw))
    z = MotionVec.zero((2,), device="cpu")
    close(z.get_vector(), JMotionVec.zero((2,)).get_vector(), 0.0)


def test_euclidean_maps():
    p, b = torch.ones(3), torch.arange(3.0)
    close(e_log_map(p), p.numpy(), 0.0)
    close(e_log_map(p, b), (p - b).numpy(), 0.0)
    close(e_exp_map(p, b), (p + b).numpy(), 0.0)
    close(e_parallel_transport(p, b, b), p.numpy(), 0.0)


def product(mod, first):
    return mod.Manifold.euclidean(first).cartesian_product(
        mod.Manifold.sphere_S3())


def manifold_points(n, first, seed):
    """n points of R^first x S^3 (unit quaternions with w > 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q[:, 0] = np.abs(q[:, 0]) + 1.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, first)), q],
                          -1).astype(np.float32)


def test_manifold_maps_match_jax():
    M, JM = product(pman, 2), product(jman, 2)
    assert (M.dim_M, M.dim_T) == (JM.dim_M, JM.dim_T) == (6, 5)
    x, b = manifold_points(16, 2, 1), manifold_points(16, 2, 2)
    v = M.log_map(t(x), t(b))
    close(v, JM.log_map(j(x), j(b)), 1e-4)
    close(M.log_map(t(x)), JM.log_map(j(x)), 1e-4)
    close(M.exp_map(v, t(b)), JM.exp_map(j(v.numpy()), j(b)))
    close(M.exp_map(M.log_map(t(x), t(b)), t(b)), x, 1e-5)
    close(M.parallel_transport(v, t(b), t(x)),
          JM.parallel_transport(j(v.numpy()), j(b), j(x)), 1e-4)
    x0 = np.float32([0.5, -0.5, 1.0, 0.0, 0.0, 0.0])
    close(M.exp_map(M.log_map(t(x0))), x0)
    for name in ("euclidean", "R", "S3", "quaternion", "sphere", "R^4"):
        assert pman.get_manifold_from_name(name).factors == tuple(
            pman._Factor(f.kind, f.dim_M, f.dim_T)
            for f in jman.get_manifold_from_name(name).factors)
    with pytest.raises(NotImplementedError):
        pman.get_manifold_from_name("SE3")


def test_karcher_mean_matches_jax():
    pts = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    E = pman.Manifold.euclidean(3)
    close(E.mean(t(pts)), pts.mean(axis=0), 1e-4)
    M, JM = product(pman, 3), product(jman, 3)
    x = manifold_points(10, 3, 4)
    close(M.mean(t(x), n_iters=10), JM.mean(j(x), n_iters=10))


def test_gaussian_matches_jax():
    M, JM = product(pman, 2), product(jman, 2)
    mean = manifold_points(1, 2, 5)[0]
    A = RNG.normal(size=(5, 5))
    cov = (A @ A.T / 5 + 0.1 * np.eye(5)).astype(np.float32)
    g, jg = pman.Gaussian(M, t(mean), t(cov)), jman.Gaussian(JM, j(mean),
                                                            j(cov))
    x = manifold_points(8, 2, 6)
    close(g.pdf(t(x)), jg.pdf(j(x)), 1e-4)
    z = np.random.default_rng(7).normal(size=(6, 5)).astype(np.float32)
    L = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
    ref = jax.vmap(lambda vi: JM.exp_map(vi, base=j(mean)))(j(z @ L.T))
    s = g.sample(6, z=t(z))
    close(s, ref, 1e-4)
    gen = torch.Generator().manual_seed(0)
    s = g.sample(6, generator=gen)
    assert s.shape == (6, 6) and torch.isfinite(s).all()
    close(torch.linalg.vector_norm(s[:, 2:], dim=-1), np.ones(6))
    B = RNG.normal(size=(5, 5)).astype(np.float32) * 0.3
    b = RNG.normal(size=(5,)).astype(np.float32) * 0.1
    for got, want in ((g.transform(t(B)), jg.transform(j(B))),
                      (g.transform(t(B), t(b)), jg.transform(j(B), j(b))),
                      (g.prod(pman.Gaussian(M, t(x[0]), t(cov * 2))),
                       jg.prod(jman.Gaussian(JM, j(x[0]), j(cov * 2))))):
        close(got.mean, want.mean, 1e-4)
        close(got.cov, want.cov, 1e-4)
    g2, jg2 = (pman.Gaussian(M, t(x[1]), t(cov * 1.5)),
               jman.Gaussian(JM, j(x[1]), j(cov * 1.5)))
    close(pman.kl_divergence_mvn(g, g2), jman.kl_divergence_mvn(jg, jg2),
          1e-4)
    E = pman.Manifold.euclidean(2)
    e1 = E.normal_distribution(torch.zeros(2), torch.eye(2))
    close(pman.kl_divergence_mvn(e1, e1), 0.0, 1e-6)
    close(e1.pdf(torch.zeros(2)), 1 / (2 * np.pi), 1e-6)


def test_traj_ops_euclidean():
    """tests/test_fk_velocities_manifold_ops.py:32-43 on the port."""
    M = pman.Manifold.euclidean(2)
    traj = torch.stack([torch.linspace(0, 1, 11), torch.linspace(0, 2, 11)],
                       dim=-1)
    vel = pops.compute_traj_velocity(traj, dt=0.1, manifold=M)
    close(vel[:-1], np.tile([1.0, 2.0], (10, 1)), 1e-5)
    _, _, a = pops.compute_traj_derivatives(traj, 0.1, M)
    close(a[:-2], np.zeros((9, 2)), 1e-4)


def s3_r3_trajs(B, H, seed):
    """(B, H, 7) trajectories of S^3 x R^3: a jittered rotation about a
    random axis and a random walk."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(B, 1, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = (np.linspace(0, 1.2, H)[None, :, None]
           + 0.05 * rng.normal(size=(B, H, 1)))
    q = q_exp_map(torch.as_tensor(ang * axis)).numpy()
    p = np.cumsum(0.02 * rng.normal(size=(B, H, 3)), axis=1)
    return np.concatenate([q, p], -1).astype(np.float32)


@pytest.mark.parametrize("smooth", [False, True])
def test_traj_ops_on_s3_x_r3_match_jax(smooth):
    M = pman.Manifold.sphere_S3().cartesian_product(
        pman.Manifold.euclidean(3))
    JM = jman.Manifold.sphere_S3().cartesian_product(
        jman.Manifold.euclidean(3))
    traj = s3_r3_trajs(2, 12, 8)
    got = pops.compute_traj_derivatives(t(traj), 0.05, M, smooth=smooth)
    ref = jops.compute_traj_derivatives(j(traj), 0.05, JM, smooth=smooth)
    for g, r, tol in zip(got, ref, (1e-5, 1e-4, 1e-3)):
        close(g, r, tol)
    close(pops.smooth_traj(t(traj), M, window=3),
          jops.smooth_traj(j(traj), JM, window=3), 1e-5)


def test_smooth_quaternion_traj_and_sample_mean():
    """tests/test_fk_velocities_manifold_ops.py's S^3 smoothing and
    tests/test_core_frame_manifold.py's sample mean, on the port."""
    M = pman.Manifold.sphere_S3()
    angles = torch.linspace(0.0, 1.0, 9)
    noise = 0.05 * ((-1.0) ** torch.arange(9))
    quats = q_exp_map((angles + noise)[:, None] * torch.tensor([0.0, 0, 1]))
    sm = pops.smooth_traj(quats, M, window=5)
    close(torch.linalg.vector_norm(sm, dim=-1), np.ones(9), 1e-5)
    close(sm[0], quats[0].numpy(), 1e-6)
    close(sm[-1], quats[-1].numpy(), 1e-6)

    def roughness(q):
        v = M.log_map(q[1:], base=q[:-1])
        return float(torch.sum(torch.square(torch.diff(v, dim=0))))
    assert roughness(sm) < roughness(quats)
    g = pman.Gaussian(pman.Manifold.euclidean(2), torch.zeros(2),
                      torch.eye(2))
    s = g.sample(2000, generator=torch.Generator().manual_seed(0))
    close(s.mean(dim=0), [0.0, 0.0], 0.1)
