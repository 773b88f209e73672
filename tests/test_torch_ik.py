"""The port's IK (kin/ik.py) vs the JAX package on the same numpy inputs:
the loss and the validity test, damped least squares (config 1's solver,
benchmarks/run_all.py config_fk_ik, at B = 16, 40 iterations, restarts
every 10) and Adam (B = 8, 60 iterations, restarts every 20), both fed
the reference's own restart draws (uniform(fold_in(key, i))).

The target is config 1's, z_rot(-pi/2) y_rot(-pi) at (0.2, 0.4, 0.1), and
the starts are uniform inside the shrunk limits: away from the kinks where
the packages' gradients differ (a clamp's bound, a zero norm).

Tolerances.  Loss and SE(3) error: float32 FK in another order, 1e-5.
DLS: ``valid`` and ``iters_to_valid`` equal; q within 2e-4 on problems
never valid; on valid problems the iterate keeps moving after convergence
by the twist's arccos at trR ~ 1, whose slope turns the trace's float32
rounding into ~5e-4 rad of rotation error a step, so there q is held to
5e-3 and the final SE(3) error to 1e-4.  Adam: q within 1e-5 on problems
never valid; near a solution the gradient nears 0 and Adam's normalized
step mu / sqrt(nu) magnifies its rounding, so valid problems are held to
2e-4, and the SE(3) errors of both solvers to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.core import se3 as jse3
from torch_robotics_tpu.kin import ik as jik
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu_torch.kin import (IKResult, ik_loss_per_q,
                                          ik_valid_mask, inverse_kinematics,
                                          inverse_kinematics_gn, robot_zoo)
from torch_robotics_tpu_torch.kin.ik import _ik_gn_run, _ik_run
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import make_ee_goal_terms

EPS_LIM = np.pi / 100
TOL_LOSS, TOL_Q_OPEN, TOL_Q_VALID, TOL_ERR = 1e-5, 2e-4, 5e-3, 1e-4
TOL_ADAM_OPEN, TOL_ADAM_VALID = 1e-5, 2e-4


@pytest.fixture(scope="module")
def setup():
    jm = jzoo.franka_panda()
    pm = robot_zoo.franka_panda(device="cpu")
    Ht = np.array(jse3.pack_homogeneous(
        jse3.z_rot(jnp.array(-jnp.pi / 2)) @ jse3.y_rot(jnp.array(-jnp.pi)),
        jnp.array([0.2, 0.4, 0.1])))[None]
    lower = (pm.q_lower + EPS_LIM).astype(np.float32)
    upper = (pm.q_upper - EPS_LIM).astype(np.float32)
    return dict(jm=jm, pm=pm, Ht=Ht, lower=lower, upper=upper)


def _starts(s, B, seed):
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (B, 7)))
    return (s["lower"] + u * (s["upper"] - s["lower"])).astype(np.float32)


def _draws(key, B, n):
    """The reference's restart uniforms, iteration by iteration."""
    return torch.tensor(np.stack([
        np.array(jax.random.uniform(jax.random.fold_in(key, i), (B, 7)))
        for i in range(n)]))


def _t(a):
    return torch.tensor(np.asarray(a))


def test_loss_and_valid_mask(setup):
    jm, pm, Ht = setup["jm"], setup["pm"], setup["Ht"]
    q = _starts(setup, 16, 1)
    q[2, 3] = pm.q_upper[3] + 0.05            # past a limit: penalized
    q_rest = np.linspace(-0.5, 0.5, 7).astype(np.float32)
    for kw in ({}, {"w_joint_limits": 10.0, "q_rest": q_rest}):
        ref = jik.ik_loss_per_q(jm, jnp.asarray(q), jnp.asarray(Ht),
                                "ee_link", **{k: jnp.asarray(v) if k ==
                                              "q_rest" else v
                                              for k, v in kw.items()})
        got = ik_loss_per_q(pm, _t(q), _t(Ht), "ee_link", **{
            k: _t(v) if k == "q_rest" else v for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL_LOSS)
    # a target the first problem reaches exactly
    H0 = np.array(jax.jit(lambda x: jik.fk_all_links(
        jm, x, link_list=["ee_link"]))(jnp.asarray(q))[:, 0])
    for H, eps in ((Ht, 1e-1), (H0[:1], 1e-1), (H0, 1e-3)):
        v_r, e_r = jik.ik_valid_mask(jm, jnp.asarray(q), jnp.asarray(H),
                                     "ee_link", se3_eps=eps)
        v, e = ik_valid_mask(pm, _t(q), _t(H), "ee_link", se3_eps=eps)
        assert np.array_equal(v.numpy(), np.asarray(v_r))
        np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=0,
                                   atol=TOL_LOSS)
    assert bool(v[0]) and not bool(v[2])      # q[2] is outside its limits


def test_dls_matches_jax_on_its_draws(setup):
    jm, pm, Ht = setup["jm"], setup["pm"], setup["Ht"]
    B, iters, every, eps = 16, 40, 10, 5e-2
    q0 = _starts(setup, B, 5)
    key = jax.random.PRNGKey(3)
    lo, hi = setup["lower"], setup["upper"]
    ref = jik._ik_gn_run(jm, jnp.asarray(Ht), "ee_link", jnp.asarray(q0),
                         jnp.asarray(lo), jnp.asarray(hi), iters, 1e-4, eps,
                         key, every)
    got = _ik_gn_run(pm, _t(Ht), "ee_link", _t(q0), _t(lo), _t(hi), iters,
                     1e-4, eps, _draws(key, B, iters), every)
    assert isinstance(got, IKResult)
    valid = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.iters_to_valid.numpy(),
                          np.asarray(ref.iters_to_valid))
    assert 0 < valid.sum() < B                 # both kinds of problems
    dq = np.abs(got.q.numpy() - np.asarray(ref.q)).max(-1)
    assert dq[~valid].max() <= TOL_Q_OPEN
    assert dq[valid].max() <= TOL_Q_VALID
    np.testing.assert_allclose(got.err_se3.numpy(), np.asarray(ref.err_se3),
                               rtol=0, atol=TOL_ERR)
    assert (got.err_se3.numpy()[valid] < eps).all()


def test_adam_matches_jax_on_its_draws(setup):
    """Three problems start 0.05 rad from a DLS solution and become valid
    (frozen); the others restart at iterations 19, 39 and 59 with their
    moments zeroed, the step count running on."""
    jm, pm, Ht = setup["jm"], setup["pm"], setup["Ht"]
    B, iters, every, lr, eps = 8, 60, 20, 1e-2, 1e-1
    lo, hi = setup["lower"], setup["upper"]
    sol = _ik_gn_run(pm, _t(Ht), "ee_link", _t(_starts(setup, 16, 5)),
                     _t(lo), _t(hi), 40, 1e-4, 5e-2,
                     _draws(jax.random.PRNGKey(3), 16, 40), 10)
    q0 = _starts(setup, B, 6)
    near = sol.q.numpy()[sol.valid.numpy()][:3]
    q0[:3] = np.clip(near + 0.05 * np.sign(np.arange(7) - 3), lo, hi)
    key = jax.random.PRNGKey(9)
    ref = jik._ik_run(jm, jnp.asarray(Ht), "ee_link", jnp.asarray(q0),
                      jnp.asarray(lo), jnp.asarray(hi), iters, lr, eps, None,
                      key=key, restart_every=every)
    got = _ik_run(pm, _t(Ht), "ee_link", _t(q0), _t(lo), _t(hi), iters, lr,
                  eps, None, _draws(key, B, iters), restart_every=every)
    valid = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.iters_to_valid.numpy(),
                          np.asarray(ref.iters_to_valid))
    assert valid[:3].all() and not valid[3:].any()
    dq = np.abs(got.q.numpy() - np.asarray(ref.q)).max(-1)
    assert dq[~valid].max() <= TOL_ADAM_OPEN
    assert dq[valid].max() <= TOL_ADAM_VALID
    np.testing.assert_allclose(got.err_se3.numpy(), np.asarray(ref.err_se3),
                               rtol=0, atol=TOL_ERR)


def test_entry_points_on_the_cpu():
    """The public solvers draw starts and restarts from a generator: DLS
    reaches config 1's target for most problems; Adam runs finite."""
    pm = robot_zoo.franka_panda(device="cpu")
    Ht = jse3.pack_homogeneous(
        jse3.z_rot(jnp.array(-jnp.pi / 2)) @ jse3.y_rot(jnp.array(-jnp.pi)),
        jnp.array([0.2, 0.4, 0.1]))
    Ht = np.array(Ht)
    res = inverse_kinematics_gn(pm, Ht, batch_size=32, max_iters=60,
                                se3_eps=5e-2, restart_every=15,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    assert res.q.shape == (32, 7) and bool(torch.isfinite(res.q).all())
    assert float(res.valid.float().mean()) >= 0.5
    again = inverse_kinematics_gn(pm, Ht, batch_size=32, max_iters=60,
                                  se3_eps=5e-2, restart_every=15,
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    assert torch.equal(res.q, again.q)
    res = inverse_kinematics(pm, Ht, batch_size=8, max_iters=20,
                             generator=torch.Generator().manual_seed(1),
                             device="cpu")
    assert bool(torch.isfinite(res.q).all())
    assert bool(torch.isfinite(res.err_se3).all())
    res = inverse_kinematics(pm, Ht, batch_size=4, max_iters=5,
                             q0=np.zeros(7, np.float32), q_rest=np.zeros(7),
                             device="cpu")
    assert bool(torch.isfinite(res.q).all())


def test_default_device_raises_without_cuda(monkeypatch):
    pm = robot_zoo.franka_panda(device="cpu")
    robot = RobotPanda.create(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inverse_kinematics_gn(pm, np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inverse_kinematics(pm, np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_ee_goal_terms(robot, np.eye(4, dtype=np.float32))
    assert make_ee_goal_terms(robot, np.eye(4, dtype=np.float32),
                              device="cpu")(torch.zeros(2, 7))[0].shape == (
        2, 14)
