"""Config 1's helpers in the port against the JAX package's: the skeleton
(``kin/skeleton.py``), the array utilities (``core/utils.py``), the seeding
helper (``core/random.py``) and the device-synchronized timer
(``core/timer.py``, the JAX ``TimerTPU`` contract with ``block_on``)."""
import random
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.core import utils as jutils
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu.kin import skeleton as jskeleton
from torch_robotics_tpu_torch.core import TimerCUDA, fix_random_seed
from torch_robotics_tpu_torch.core import utils
from torch_robotics_tpu_torch.kin import (Skeleton,
                                          get_skeleton_from_landmarks,
                                          get_skeleton_from_model,
                                          robot_zoo)

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("name", ["franka_panda", "tiago_dual_holo",
                                  "shadow_hand"])
def test_skeleton_from_model_matches_jax(name):
    model = getattr(robot_zoo, name)(device="cpu")
    jmodel = getattr(jzoo, name)()
    q = RNG.uniform(-1, 1, model.n_dofs).astype(np.float32)
    sk = get_skeleton_from_model(model, torch.as_tensor(q))
    jsk = jskeleton.get_skeleton_from_model(jmodel, q)
    assert sk.link_names == jsk.link_names
    assert sk.parent_idx == jsk.parent_idx and sk.edges == jsk.edges
    assert sk.positions.dtype == np.float32
    np.testing.assert_allclose(sk.positions, jsk.positions, atol=2e-5)
    lengths, jlengths = sk.link_lengths(), jsk.link_lengths()
    assert lengths.keys() == jlengths.keys()
    np.testing.assert_allclose(list(lengths.values()),
                               list(jlengths.values()), atol=2e-5)
    np.testing.assert_allclose(sk.compute_self_distance(),
                               jsk.compute_self_distance(), atol=4e-5)
    # the skeleton takes numpy and lists as the JAX one does
    np.testing.assert_array_equal(
        get_skeleton_from_model(model, q.tolist()).positions, sk.positions)


class _Landmark(types.SimpleNamespace):
    pass


@pytest.mark.parametrize("mirror,relative", [(False, False), (True, False),
                                             (False, True)])
def test_skeleton_from_landmarks_matches_jax(mirror, relative):
    lms = [_Landmark(x=float(a), y=float(b), z=float(c), visibility=float(v))
           for a, b, c, v in RNG.uniform(0, 1, (8, 4))]
    lms[3].visibility = 0.1                     # below the threshold
    conns = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (7, 7)]
    kw = dict(mirror=mirror, relative_pose=relative,
              shift=np.array([0.1, 0.0, -0.2]))
    sk = get_skeleton_from_landmarks(lms, conns, **kw)
    jsk = jskeleton.get_skeleton_from_landmarks(lms, conns, **kw)
    assert sk.link_names == jsk.link_names
    assert sk.parent_idx == jsk.parent_idx
    np.testing.assert_array_equal(sk.positions, jsk.positions)
    np.testing.assert_array_equal(sk.variances, jsk.variances)
    assert get_skeleton_from_landmarks(None, conns) is None
    with pytest.raises(ValueError, match="out of range"):
        get_skeleton_from_landmarks(lms, [(0, 9)])


def test_sample_posture_and_draw():
    sk = Skeleton(link_names=["a", "b", "c"], parent_idx=[-1, 0, 1],
                  positions=np.array([[0, 0, 0], [0, 0, 1.0], [0, 1, 1.0]]),
                  variances=np.array([1e-4, 4e-4, 1e-2]))
    g = torch.Generator().manual_seed(0)
    x = sk.sample_posture(g, 20000)
    assert tuple(x.shape) == (20000, 3, 3) and x.dtype == torch.float32
    np.testing.assert_allclose(x.mean(0).numpy(), sk.positions, atol=5e-3)
    np.testing.assert_allclose(x.var(0).numpy(),
                               np.repeat(sk.variances[:, None], 3, 1),
                               rtol=0.05)
    assert torch.equal(sk.sample_posture(torch.Generator().manual_seed(0),
                                         20000), x)

    class Ax:
        name = "3d"
        calls = []

        def plot(self, *args, **kw):
            self.calls.append((args, kw))
    ax = Ax()
    assert sk.draw_skeleton(ax=ax, color="red") is ax
    assert len(ax.calls) == 2 and len(ax.calls[0][0]) == 3
    np.testing.assert_array_equal(ax.calls[1][0][1], [0, 1])
    # without an axis it draws on a new 3-D one (matplotlib imported there)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ax3 = sk.draw_skeleton()
    assert ax3.name == "3d" and len(ax3.lines) == 2
    plt.close(ax3.figure)


def _pair(shape, dtype=np.float32):
    return RNG.normal(size=shape).astype(dtype)


def test_core_utils_match_jax():
    pts = _pair((3, 7, 4))
    np.testing.assert_allclose(utils.batch_cov(torch.as_tensor(pts)),
                               jutils.batch_cov(jnp.asarray(pts)), atol=1e-6)
    covs = _pair((5, 4, 4))
    np.testing.assert_allclose(utils.batch_trace(torch.as_tensor(covs)),
                               jutils.batch_trace(jnp.asarray(covs)),
                               atol=1e-6)
    a, b = _pair((2, 3)), _pair((2, 3))
    np.testing.assert_allclose(
        utils.tensor_linspace(torch.as_tensor(a), torch.as_tensor(b), 7),
        jutils.tensor_linspace(jnp.asarray(a), jnp.asarray(b), 7), atol=1e-6)
    x, M, y = _pair((2, 4, 5)), _pair((4, 4)), _pair((2, 4, 5))
    np.testing.assert_allclose(
        utils.batched_weighted_dot_prod(*map(torch.as_tensor, (x, M, y))),
        jutils.batched_weighted_dot_prod(*map(jnp.asarray, (x, M, y))),
        rtol=1e-5, atol=1e-5)
    for kw, shape in (({}, (6, 5, 3)), ({"w_pos": 2.0}, (6, 5, 3)),
                      ({"normalized_input": True}, (5, 3))):
        xb, xt = _pair(shape), _pair(shape)
        np.testing.assert_allclose(
            utils.euclidean_distance(torch.as_tensor(xb), torch.as_tensor(xt),
                                     **kw),
            jutils.euclidean_distance(jnp.asarray(xb), jnp.asarray(xt), **kw),
            rtol=1e-5, atol=1e-6)
    for dim in (None, 0, -2):
        X = _pair((4, 3))
        np.testing.assert_allclose(
            utils.MinMaxScaler(dim=dim).scale(torch.as_tensor(X)),
            jutils.MinMaxScaler(dim=dim).scale(jnp.asarray(X)), atol=1e-6)
    traj = _pair((2, 9, 3))
    for method in ("forward", "backward", "central"):
        np.testing.assert_allclose(
            utils.finite_difference_vector(torch.as_tensor(traj), 0.1,
                                           method),
            jutils.finite_difference_vector(jnp.asarray(traj), 0.1, method),
            rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        utils.finite_difference_vector(torch.as_tensor(traj), method="x")
    spd = np.array([[2.0, 0.5], [0.5, 1.0]])
    for m in (spd, np.diag([1.0, 0.0]), np.diag([1.0, -1.0]),
              np.array([[1.0, 2.0], [0.0, 1.0]])):
        assert (utils.is_positive_semi_definite(torch.as_tensor(m))
                == jutils.is_positive_semi_definite(m))
        assert (utils.is_positive_definite(torch.as_tensor(m))
                == jutils.is_positive_definite(m))
    ia, ib = np.array([5, 1, 3, 9, 3]), np.array([3, 7, 9, 0])
    np.testing.assert_array_equal(
        utils.torch_intersect_1d(torch.as_tensor(ia), torch.as_tensor(ib)),
        jutils.torch_intersect_1d(ia, ib))


def test_to_numpy_and_to_torch():
    t = torch.arange(6.0).reshape(2, 3)
    for v in (t, t.numpy(), t.tolist()):
        out = utils.to_numpy(v)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, jutils.to_numpy(np.asarray(v)))
    assert utils.to_numpy(t, np.float64).dtype == np.float64
    x = utils.to_torch([[1, 2], [3, 4]], device="cpu")
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert utils.to_torch(t, torch.float64, "cpu").dtype == torch.float64
    assert utils.DEFAULT_POLICY.compute == utils.DEFAULT_DTYPE


def test_fix_random_seed():
    draws = []
    for _ in range(2):
        gen = fix_random_seed(7, device="cpu")
        draws.append((random.random(), np.random.rand(3).tolist(),
                      torch.rand(3).tolist(),
                      torch.rand(3, generator=gen).tolist()))
    assert draws[0] == draws[1]
    assert fix_random_seed(8, device="cpu").initial_seed() == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fix_random_seed(7)


def test_timer_contract():
    """Built for the CPU it reads the host clock over the block, block_on
    taken; a CUDA timer without a card raises at construction, as every
    entry point of the port."""
    with TimerCUDA(device="cpu") as t:
        time.sleep(0.02)
        t.block_on(torch.ones(2))
    assert 0.02 <= t.elapsed < 1.0
    with TimerCUDA(device="cpu") as t2:
        pass
    assert 0.0 <= t2.elapsed < t.elapsed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TimerCUDA()


def test_config1_examples_run_on_the_cpu(capsys):
    """The port's config-1 entry points, asked for the CPU, at a small
    size: FK over the zoo (shapes, finite) and the Panda's IK."""
    from torch_robotics_tpu_torch.examples import (forward_kinematics,
                                                   inverse_kinematics)
    out = forward_kinematics.main("cpu", batch_size=2)
    assert set(out) == set(forward_kinematics.ZOO)
    for H in out.values():
        assert H.shape[0] == 2 and tuple(H.shape[-2:]) == (4, 4)
        assert bool(torch.isfinite(H).all())
    res, skeletons = inverse_kinematics.main("cpu", batch_size=2,
                                             max_iters=5)
    assert tuple(res.q.shape) == (2, 7) and bool(torch.isfinite(res.q).all())
    assert len(skeletons) == int(res.valid.sum())
    assert "Panda IK" in capsys.readouterr().out
