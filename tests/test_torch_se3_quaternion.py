"""The port's quaternion and SE(3) core (``core/quaternion.py``,
``core/se3.py``) against the JAX package, on the same numpy arrays as
tests/test_core_quaternion.py and tests/test_core_se3.py:49-138 use (64
unit quaternions, 32 tangent vectors, 8 transforms), made from a seed:

- every function's values against the JAX function's in float32, to 1e-5
  absolute of max(1, max|ref|) (1e-4 for the maps through arccos near the
  identity and the parallel transport), and the JAX tests' own properties
  (identities, round trips, known rotations) at their tolerances;
- autograd gradients finite where the reference's are (q_to_rotation_matrix,
  rotation_matrix_to_q at the identity, acos_linear_extrapolation past its
  bounds);
- ``ee_se3_cost`` of a Panda's link poses against the JAX cost.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_robotics_tpu.core as J
import torch_robotics_tpu.core.se3 as jse3
import torch_robotics_tpu_torch.core as P
from torch_robotics_tpu.costs import ee_se3_cost as jax_ee_se3_cost
from torch_robotics_tpu_torch.costs import ee_se3_cost

TOL = 1e-5


def unit_quats(n, seed=0):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def both(name, *args, tol=TOL, **kw):
    """P.name and J.name on the same arrays, held together."""
    got = getattr(P, name)(*[torch.as_tensor(a) for a in args], **kw)
    ref = getattr(J, name, None) or getattr(jse3, name)
    ref = ref(*[jnp.asarray(a) for a in args], **kw)
    if isinstance(got, tuple):
        for g, r in zip(got, ref):
            close(g, r, tol)
    else:
        close(got, ref, tol)
    return got


Q = unit_quats(64)
# tangent vectors of norm < pi / 2: exp gives w > 0, so log (which maps q
# and -q alike) inverts it
V = (np.random.default_rng(1).normal(size=(32, 3)) * 0.5).astype(np.float32)
V *= np.minimum(1.0, 1.5 / np.linalg.norm(V, axis=-1, keepdims=True))
# axis-angle vectors with angles in (0, pi), where the map is one to one
AA = np.random.default_rng(2).normal(size=(32, 3)).astype(np.float32)
AA *= (np.pi * np.random.default_rng(2).uniform(0.05, 0.95, (32, 1))
       / np.linalg.norm(AA, axis=-1, keepdims=True)).astype(np.float32)
EUL = np.random.default_rng(3).uniform(-1, 1, (32, 3)).astype(np.float32)
IDQ = np.tile(np.float32([1, 0, 0, 0]), (4, 1))


@pytest.mark.parametrize("name,args,tol", [
    ("q_mul", (Q[:32], Q[32:]), TOL),
    ("q_mul", (np.float32([1, 0, 0, 0]), Q), TOL),
    ("q_inverse", (Q,), TOL),
    ("q_div", (Q[:32], Q[32:]), TOL),
    ("q_norm_squared", (Q * 1.5,), TOL),
    ("q_to_quaternion_matrix", (Q,), TOL),
    ("q_exp_map", (V,), TOL),
    ("q_exp_map", (np.zeros((4, 3), np.float32),), TOL),
    ("q_exp_map", (V, Q[:32]), TOL),
    ("q_log_map", (Q,), 1e-4),
    ("q_log_map", (IDQ,), TOL),
    ("q_log_map", (Q[:32], Q[32:]), 1e-4),
    ("q_to_axis_angles", (Q,), 1e-4),
    ("axis_angles_to_q", (AA,), TOL),
    ("axis_angles_to_q", (np.zeros((2, 3), np.float32),), TOL),
    ("euler_to_q", (EUL,), TOL),
    ("q_to_euler", (Q,), TOL),
    ("q_convert_xyzw", (Q,), 0.0),
    ("q_convert_wxyz", (Q,), 0.0),
    ("q_parallel_transport", (V, Q[:32], Q[32:]), 1e-4),
    ("q_parallel_transport", (V[:4], IDQ, IDQ), TOL),
])
def test_quaternion_functions_match_jax(name, args, tol):
    both(name, *args, tol=tol)


def test_quaternion_properties():
    """tests/test_core_quaternion.py's assertions on the port."""
    q = torch.as_tensor(Q)
    ident = torch.tensor([1.0, 0, 0, 0]).expand(64, 4)
    close(P.q_mul(q, P.q_inverse(q)), ident)
    close(P.q_div(q, q), ident)
    close((P.q_to_quaternion_matrix(q[:32]) @ q[32:, :, None])[..., 0],
          P.q_mul(q[:32], q[32:]).numpy(), 1e-6)
    v = torch.as_tensor(V)
    e = P.q_exp_map(v)
    close(torch.linalg.vector_norm(e, dim=-1), np.ones(32))
    close(P.q_log_map(e), V, 1e-4)
    close(P.q_to_axis_angles(P.axis_angles_to_q(torch.as_tensor(AA))), AA,
          1e-4)
    close(P.q_to_euler(P.euler_to_q(torch.as_tensor(EUL))), EUL)
    close(P.q_convert_wxyz(P.q_convert_xyzw(q)), Q, 0.0)
    close(P.q_exp_map(torch.zeros(4, 3)), IDQ, 1e-7)


def test_quaternion_gradients_are_finite():
    q = torch.as_tensor(unit_quats(8, 4)).requires_grad_(True)
    g, = torch.autograd.grad(P.q_to_rotation_matrix(q).sum(), q)
    assert torch.isfinite(g).all()
    R = torch.eye(3).repeat(2, 1, 1).requires_grad_(True)
    g, = torch.autograd.grad(P.rotation_matrix_to_q(R).sum(), R)
    assert torch.isfinite(g).all()
    v = torch.zeros(3, 3, requires_grad=True)
    g, = torch.autograd.grad(P.q_exp_map(v).sum(), v)
    assert torch.isfinite(g).all()


ANG = np.random.default_rng(5).uniform(0, 1, (8,)).astype(np.float32)
T1 = np.random.default_rng(6).normal(size=(8, 3)).astype(np.float32)
OMEGA = np.float32([[0.1, 0.2, -0.3], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]])


def _R(fn, a):
    return np.array(getattr(J, fn)(jnp.asarray(a)))


@pytest.mark.parametrize("name,args", [
    ("vector3_to_skew_symm_matrix", (T1,)),
    ("skew_symm_matrix_to_vec", (np.array(
        J.vector3_to_skew_symm_matrix(jnp.asarray(T1))),)),
    ("multiply_transform", (_R("z_rot", ANG), T1, _R("x_rot", ANG[::-1]),
                            np.ones((8, 3), np.float32))),
    ("invert_transform", (_R("z_rot", ANG), T1)),
    ("multiply_inv_transform", (_R("z_rot", ANG), T1,
                                _R("y_rot", ANG[::-1]), T1[::-1].copy())),
    ("transform_point", (np.float32([[1, 0, 0], [0, 1, 0]]),
                         _R("z_rot", np.float32(np.pi / 2)),
                         np.float32([1, 0, 0]))),
    ("transform_point", (T1, _R("z_rot", ANG), T1[::-1].copy())),
    ("exp_map_so3", (OMEGA,)),
    ("minus_SO3", (_R("z_rot", ANG), _R("x_rot", ANG[::-1]))),
])
def test_se3_functions_match_jax(name, args):
    both(name, *args)


def test_se3_properties():
    """tests/test_core_se3.py:49-138's assertions on the port."""
    R1, t1 = P.z_rot(torch.as_tensor(ANG)), torch.as_tensor(T1)
    R_inv, t_inv = P.invert_transform(R1, t1)
    R_id, t_id = P.multiply_transform(R1, t1, R_inv, t_inv)
    close(R_id, np.tile(np.eye(3), (8, 1, 1)))
    close(t_id, np.zeros((8, 3)))
    R2, t2 = P.x_rot(torch.as_tensor(ANG[::-1].copy())), torch.ones(8, 3)
    Rc, tc = P.multiply_transform(R1, t1, R2, t2)
    H = P.pack_homogeneous(R1, t1) @ P.pack_homogeneous(R2, t2)
    close(Rc, H[..., :3, :3].numpy())
    close(tc, H[..., :3, 3].numpy())
    p = P.transform_point(torch.tensor([1.0, 0, 0]),
                          P.z_rot(torch.tensor(np.pi / 2)),
                          torch.tensor([1.0, 0, 0]))
    close(p, [1.0, 1.0, 0.0], 1e-6)
    S = P.vector3_to_skew_symm_matrix(torch.tensor([[1.0, -2.0, 3.0]]))
    close(S + S.transpose(-1, -2), np.zeros((1, 3, 3)), 0.0)
    close(P.skew_symm_matrix_to_vec(S), [[1.0, -2.0, 3.0]], 0.0)
    close(S[0] @ torch.full((3,), 0.5),
          np.cross([1.0, -2.0, 3.0], [0.5, 0.5, 0.5]), 1e-6)
    om = torch.as_tensor(OMEGA[:2])
    close(P.skew_symm_matrix_to_vec(P.log_SO3(P.exp_map_so3(om))),
          OMEGA[:2], 1e-4)
    close(P.exp_map_so3(torch.zeros(1, 3)), np.eye(3)[None], 0.0)
    x = torch.linspace(-1.2, 1.2, 101, requires_grad=True)
    g, = torch.autograd.grad(P.acos_linear_extrapolation(x).sum(), x)
    assert torch.isfinite(g).all()


def test_ee_se3_cost_matches_jax():
    """The last link's SE(3) distance to a target, squared and not, with
    the weights the reference's defaults and others."""
    from torch_robotics_tpu.kin import fk_all_links as jfk
    from torch_robotics_tpu.kin import robot_zoo as jzoo
    from torch_robotics_tpu_torch.kin import fk_all_links, robot_zoo
    q = np.random.default_rng(7).uniform(-1, 1, (16, 7)).astype(np.float32)
    H = fk_all_links(robot_zoo.franka_panda(device="cpu"), torch.as_tensor(q))
    jH = jfk(jzoo.franka_panda(), jnp.asarray(q))
    close(H, jH)
    target = np.asarray(J.pack_homogeneous(J.z_rot(jnp.asarray(0.3)),
                                           jnp.asarray([0.4, 0.1, 0.5])))
    for kw in ({}, {"square": False}, {"w_pos": 2.0, "w_rot": 0.5}):
        close(ee_se3_cost(H, torch.as_tensor(target), **kw),
              jax_ee_se3_cost(jH, jnp.asarray(target), **kw))
