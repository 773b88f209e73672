"""The port's array-of-structures FK chain, its Jacobians, the base-pose
arguments of ``fk_all_links``, the robots' EE accessors and the SE(3)
helpers vs the JAX package on the same numpy inputs (the Panda and the
UR10, B = 16; the forward-mode analytical Jacobian at B = 4).

Tolerance: float32 products summed in another order, 1e-6 absolute on
poses, velocities and Jacobians of unit-scale entries (a few ulps of
their max); 1e-5 on the analytical Jacobian, whose quaternion rows divide
by 2 |q_w| (>= 0.2).  The JAX side runs jitted: its eager vmapped
jacfwd takes ~10 s to trace."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.core import se3 as jse3
from torch_robotics_tpu.kin import fk as jfk
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu_torch.core import se3
from torch_robotics_tpu_torch.kin import (analytical_jacobian, fk_all_links,
                                          fk_link_positions, fk_rot_trans,
                                          fk_with_velocities,
                                          geometric_jacobian,
                                          local_joint_transforms,
                                          point_jacobians, robot_zoo)
from torch_robotics_tpu_torch.robots import RobotPanda, RobotUR10

B, B_AJ = 16, 4
TOL, TOL_AJ = 1e-6, 1e-5


@pytest.fixture(scope="module", params=["franka_panda", "ur10"])
def robot(request):
    name = request.param
    jm = getattr(jzoo, name)()
    pm = getattr(robot_zoo, name)(device="cpu")
    rng = np.random.default_rng(3)
    lo, hi = pm.q_lower.astype(np.float64), pm.q_upper.astype(np.float64)
    q = (lo + rng.uniform(size=(B, pm.n_dofs)) * (hi - lo)).astype(np.float32)
    # two lanes past a clamp: their Jacobian columns are masked
    q[0, 1] = hi[1] + 0.2
    q[1, 0] = lo[0] - 0.1
    qd = rng.normal(size=q.shape).astype(np.float32)
    rb = (np.asarray(jse3.z_rot(jnp.asarray(0.7)))
          @ np.asarray(jse3.y_rot(jnp.asarray(-0.3)))).astype(np.float32)
    tb = np.asarray([0.2, -0.4, 0.1], np.float32)
    rbb = np.stack([np.asarray(jse3.z_rot(jnp.asarray(a)))
                    for a in rng.uniform(-3, 3, size=B)]).astype(np.float32)
    tbb = rng.normal(size=(B, 3)).astype(np.float32)
    return dict(jm=jm, pm=pm, q=q, qd=qd, base=(rb, tb),
                batched_base=(rbb, tbb))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_local_transforms_and_fk_rot_trans(robot):
    jm, pm, q = robot["jm"], robot["pm"], robot["q"]
    for got, ref in zip(local_joint_transforms(pm, _t(q)),
                        jfk.local_joint_transforms(jm, jnp.asarray(q))):
        _close(got, ref)
    for got, ref in zip(fk_rot_trans(pm, _t(q)),
                        jfk.fk_rot_trans(jm, jnp.asarray(q))):
        _close(got, ref)
    # one sample, no batch
    for got, ref in zip(fk_rot_trans(pm, _t(q[5])),
                        jfk.fk_rot_trans(jm, jnp.asarray(q[5]))):
        _close(got, ref)


@pytest.mark.parametrize("which", ["rot", "trans", "both"])
def test_fk_rot_trans_base_pose(robot, which):
    jm, pm, q = robot["jm"], robot["pm"], robot["q"]
    rb, tb = robot["base"]
    kw = dict(base_rot=rb if which != "trans" else None,
              base_trans=tb if which != "rot" else None)
    ref = jfk.fk_rot_trans(jm, jnp.asarray(q), **{
        k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = fk_rot_trans(pm, _t(q), **{k: None if v is None else _t(v)
                                     for k, v in kw.items()})
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("batched", [False, True])
def test_fk_all_links_base_pose(robot, batched):
    jm, pm, q = robot["jm"], robot["pm"], robot["q"]
    rb, tb = robot["batched_base" if batched else "base"]
    ref = jfk.fk_all_links(jm, jnp.asarray(q), base_rot=jnp.asarray(rb),
                           base_trans=jnp.asarray(tb))
    _close(fk_all_links(pm, _t(q), base_rot=_t(rb), base_trans=_t(tb)), ref)
    # a subset of links, translation only
    names = [pm.link_names[-1], pm.link_names[2]]
    ref = jfk.fk_all_links(jm, jnp.asarray(q), link_list=names,
                           base_trans=jnp.asarray(tb))
    _close(fk_all_links(pm, _t(q), link_list=names, base_trans=_t(tb)), ref)


def test_fk_link_positions_and_velocities(robot):
    jm, pm, q, qd = robot["jm"], robot["pm"], robot["q"], robot["qd"]
    _close(fk_link_positions(pm, _t(q)),
           jfk.fk_link_positions(jm, jnp.asarray(q)))
    _close(fk_link_positions(pm, _t(q), link_idxs=[1, 3]),
           jfk.fk_link_positions(jm, jnp.asarray(q), link_idxs=[1, 3]))
    ref = jfk.fk_with_velocities(jm, jnp.asarray(q), jnp.asarray(qd))
    got = fk_with_velocities(pm, _t(q), _t(qd))
    for g, r in zip(got, ref):
        _close(g, r, tol=4 * TOL)       # velocities up to ~3 in size


def test_geometric_and_point_jacobians(robot):
    jm, pm, q = robot["jm"], robot["pm"], robot["q"]
    for link in ("ee_link", pm.link_names[3]):
        ref = jfk.geometric_jacobian(jm, jnp.asarray(q), link)
        got = geometric_jacobian(pm, _t(q), link)
        for g, r in zip(got, ref):
            _close(g, r)
    R, t = fk_rot_trans(pm, _t(q))
    jR, jt = jfk.fk_rot_trans(jm, jnp.asarray(q))
    links = list(range(pm.n_links))
    for kw, jkw in (({}, {}), ({"q": _t(q)}, {"q": jnp.asarray(q)})):
        ref = jfk.point_jacobians(jm, jR, jt, jt, links, **jkw)
        _close(point_jacobians(pm, R, t, t, links, **kw), ref)
    # points off the link origins
    pts = np.asarray(jt) + 0.05
    ref = jfk.point_jacobians(jm, jR, jt, jnp.asarray(pts), links)
    _close(point_jacobians(pm, R, t, _t(pts), links), ref)


def test_analytical_jacobian(robot):
    jm, pm, q = robot["jm"], robot["pm"], robot["q"][2:2 + B_AJ]
    ref = jax.jit(lambda x: jfk.analytical_jacobian(jm, x))(jnp.asarray(q))
    got = analytical_jacobian(pm, _t(q))
    assert got.shape == (B_AJ, pm.n_links, 7, pm.n_dofs)
    _close(got, ref, tol=TOL_AJ)
    names = ["ee_link"]
    ref = jax.jit(lambda x: jfk.analytical_jacobian(jm, x, link_list=names))(
        jnp.asarray(q[0]))
    _close(analytical_jacobian(pm, _t(q[0]), link_list=names), ref,
           tol=TOL_AJ)


def test_ee_accessors():
    jrobot = JRobotPanda.create()
    q = np.random.default_rng(4).uniform(-1, 1, size=(B, 7)).astype(
        np.float32)
    probot = RobotPanda.create(device="cpu")
    assert probot.link_name_ee == "ee_link"
    _close(probot.get_EE_pose(_t(q)), jrobot.get_EE_pose(jnp.asarray(q)))
    _close(probot.get_EE_position(_t(q)),
           jrobot.get_EE_position(jnp.asarray(q)))
    _close(probot.get_EE_orientation(_t(q)),
           jrobot.get_EE_orientation(jnp.asarray(q)))
    _close(probot.get_EE_orientation(_t(q), rotation_matrix=False),
           jrobot.get_EE_orientation(jnp.asarray(q), rotation_matrix=False),
           tol=TOL_AJ)
    ur10 = RobotUR10(device="cpu")
    assert ur10.link_name_ee == "ee_link"
    H = ur10.get_EE_pose(_t(q[:, :6]))
    assert H.shape == (B, 1, 4, 4)
    _close(ur10.get_EE_position(_t(q[:, :6])), H[:, 0, :3, 3].numpy())


def test_se3_helpers():
    """The relative rotations have angles in [0.3, 2.5] rad: away from 0
    and pi, where log_SO3's arccos and 1 / sin amplify float32 rounding."""
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(0.3, 2.5, size=B)
    R1 = np.asarray(jse3.axis_angle_rotation(jnp.asarray(axis, jnp.float32),
                                             jnp.asarray(ang, jnp.float32)))
    R2 = np.asarray(jse3.z_rot(jnp.asarray(rng.uniform(-3, 3, size=B),
                                           jnp.float32)))
    t1 = rng.normal(size=(B, 3)).astype(np.float32)
    t2 = rng.normal(size=(B, 3)).astype(np.float32)
    H1 = np.asarray(jse3.pack_homogeneous(jnp.asarray(R1 @ R2),
                                          jnp.asarray(t1)))
    H2 = np.asarray(jse3.pack_homogeneous(jnp.asarray(R2), jnp.asarray(t2)))
    _close(se3.pack_homogeneous(_t(R1 @ R2), _t(t1)), H1, tol=0)
    _close(se3.pack_homogeneous(_t(R2), _t(t2[0])), jse3.pack_homogeneous(
        jnp.asarray(R2), jnp.asarray(t2[0])), tol=0)
    for g, r in zip(se3.unpack_homogeneous(_t(H1)),
                    jse3.unpack_homogeneous(jnp.asarray(H1))):
        _close(g, r, tol=0)
    for w_pos, w_rot in ((1.0, 1.0), (0.5, 0.0), (0.0, 2.0)):
        _close(se3.SE3_distance(_t(H1), _t(H2), w_pos, w_rot),
               jse3.SE3_distance(jnp.asarray(H1), jnp.asarray(H2), w_pos,
                                 w_rot))
    _close(se3.so3_relative_angle(_t(H1[:, :3, :3]), _t(H2[:, :3, :3])),
           jse3.so3_relative_angle(jnp.asarray(H1[:, :3, :3]),
                                   jnp.asarray(H2[:, :3, :3])), tol=1e-5)
    _close(se3.log_SO3(_t(R1)), jse3.log_SO3(jnp.asarray(R1)), tol=1e-5)
    x = np.linspace(-1.2, 1.2, 49).astype(np.float32)
    _close(se3.acos_linear_extrapolation(_t(x)),
           jse3.acos_linear_extrapolation(jnp.asarray(x)), tol=1e-5)
    with pytest.raises(ValueError):
        se3.acos_linear_extrapolation(_t(x), (0.5, 0.2))
    with pytest.raises(ValueError):
        se3.acos_linear_extrapolation(_t(x), (-1.0, 0.2))
    H = np.asarray(H1)
    _close(se3.link_pos_from_link_tensor(_t(H)),
           jse3.link_pos_from_link_tensor(jnp.asarray(H)), tol=0)
    _close(se3.link_rot_from_link_tensor(_t(H[..., :3, :3])),
           jse3.link_rot_from_link_tensor(jnp.asarray(H[..., :3, :3])),
           tol=0)
    _close(se3.link_quat_from_link_tensor(_t(H)),
           jse3.link_quat_from_link_tensor(jnp.asarray(H)), tol=1e-6)
