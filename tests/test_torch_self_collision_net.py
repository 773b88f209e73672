"""The port's learned self-collision net vs the JAX package's on the same
numpy inputs: the bundled checkpoint and seeded relu / tanh nets, values,
gradients, collision flags, the npz round trip and the fitting labels.

Tolerance: rtol 1e-5, atol 1e-6 on values (float32 sums over up to 256
inputs in another order), the same on gradients relative to their max."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.costs.fields import \
    self_collision_distances as jax_self_collision_distances
from torch_robotics_tpu.costs.self_collision_net import \
    SelfCollisionNet as JSelfCollisionNet
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu_torch.costs import (SelfCollisionNet,
                                            fit_self_collision_net,
                                            self_collision_labels)
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.utils.files import get_data_path

NPZ = get_data_path() / "panda_self_collision_net.npz"
RTOL, ATOL = 1e-5, 1e-6


def numpy_net(widths, activation, seed, like=None):
    """He-normal weights and small biases from a numpy seed, as npz-keyed
    float32 arrays; normalization from ``like`` (a net's arrays) or the
    identity, output scale (1, 0)."""
    rng = np.random.default_rng(seed)
    out = {"activation": activation,
           "scale_out": np.asarray([1.0, 0.0], np.float32)}
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        out["W%d" % i] = (rng.normal(size=(n_in, n_out))
                          * np.sqrt(2.0 / n_in)).astype(np.float32)
        out["b%d" % i] = (0.1 * rng.normal(size=n_out)).astype(np.float32)
    d = widths[0]
    out["mean_q"] = (np.zeros(d, np.float32) if like is None
                     else np.asarray(like["mean_q"], np.float32))
    out["std_q"] = (np.ones(d, np.float32) if like is None
                    else np.asarray(like["std_q"], np.float32))
    return out


def numpy_raw(arrays, q):
    """The net's raw output on q (N, d), in float64 numpy."""
    x = (q - arrays["mean_q"]) / arrays["std_q"]
    n_layers = sum(1 for k in arrays if k.startswith("W"))
    act = np.tanh if arrays["activation"] == "tanh" else (
        lambda v: np.maximum(v, 0.0))
    for i in range(n_layers):
        x = x @ arrays["W%d" % i].astype(np.float64) + arrays["b%d" % i]
        if i + 1 < n_layers:
            x = act(x)
    s = arrays["scale_out"].astype(np.float64)
    return x[:, 0] * s[0] + s[1]


def spread(arrays, q, cutoff=0.001):
    """``arrays`` with scale_out[1] set so that the hinge relu(cutoff - sd)
    is active on about half of the configurations q (N, d)."""
    out = dict(arrays)
    raw = numpy_raw(arrays, q.astype(np.float64))
    out["scale_out"] = np.asarray(
        [arrays["scale_out"][0], arrays["scale_out"][1] - np.median(raw)
         - cutoff], np.float32)
    return out


def jax_net(arrays):
    n = sum(1 for k in arrays if k.startswith("W"))
    return JSelfCollisionNet(
        weights=tuple((jnp.asarray(arrays["W%d" % i]),
                       jnp.asarray(arrays["b%d" % i])) for i in range(n)),
        mean_q=jnp.asarray(arrays["mean_q"]),
        std_q=jnp.asarray(arrays["std_q"]),
        scale_out=jnp.asarray(arrays["scale_out"]),
        activation=arrays["activation"])


def box_q(n, seed):
    """q (n, 7) uniform in the Panda's joint box."""
    model = RobotPanda.create(device="cpu").model
    rng = np.random.default_rng(seed)
    lo, hi = model.q_lower, model.q_upper
    return (lo + rng.uniform(size=(n, 7)) * (hi - lo)).astype(np.float32)


def _pair(kind):
    if kind == "bundled":
        return (JSelfCollisionNet.from_npz(NPZ),
                SelfCollisionNet.from_npz(NPZ, device="cpu"))
    act = kind.split("_")[0]
    with np.load(NPZ) as data:
        arrays = numpy_net([7, 32, 16, 1], act, seed=11, like=data)
    arrays = spread(arrays, box_q(512, seed=12))
    return jax_net(arrays), SelfCollisionNet.from_arrays(arrays, "cpu")


@pytest.mark.parametrize("kind", ["bundled", "relu_7_32_16_1",
                                  "tanh_7_32_16_1"])
def test_values_and_flags_match_jax(kind):
    jnet, net = _pair(kind)
    q = box_q(2048, seed=1)
    if kind == "bundled":
        assert net.widths == (7, 256, 128, 64, 1)
        assert net.activation == "relu"
    for name in ("raw_distance", "signed_distance", "cost"):
        got = getattr(net, name)(torch.as_tensor(q)).numpy()
        ref = np.asarray(getattr(jnet, name)(jnp.asarray(q)))
        assert got.shape == ref.shape == (2048,)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    sd = np.asarray(jnet.signed_distance(jnp.asarray(q)))
    # the task's threshold, and one inside the spread of sd (the bundled
    # net saturates: half its values lie within 1e-4 of 0.3266)
    inner = 0.2 if kind == "bundled" else float(np.median(sd))
    assert 0 < int((sd < inner).sum()) < 2048
    for threshold in (-0.05, inner):
        got = net.collision(torch.as_tensor(q), threshold).numpy()
        ref = np.asarray(jnet.collision(jnp.asarray(q), threshold))
        edge = np.abs(sd - threshold) < 1e-5
        assert int(edge.sum()) <= 2
        np.testing.assert_array_equal(got[~edge], ref[~edge])


@pytest.mark.parametrize("kind", ["bundled", "relu_7_32_16_1",
                                  "tanh_7_32_16_1"])
def test_gradient_matches_jax_grad(kind):
    jnet, net = _pair(kind)
    q = box_q(512, seed=2)
    sd, grad = net.signed_distance_and_grad(torch.as_tensor(q))
    ref = np.asarray(jax.vmap(jax.grad(jnet.signed_distance))(
        jnp.asarray(q)))
    np.testing.assert_allclose(sd.numpy(),
                               np.asarray(jnet.signed_distance(q)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), ref, rtol=RTOL,
                               atol=ATOL * np.abs(ref).max())


def test_float64_input_follows_its_dtype():
    """A float32 checkpoint evaluated on float64 q runs in float64 and
    agrees with JAX in 64-bit mode to float64 rounding."""
    net = SelfCollisionNet.from_npz(NPZ, device="cpu")
    q = box_q(256, seed=3).astype(np.float64)
    got = net.signed_distance_and_grad(torch.as_tensor(q))
    assert all(t.dtype == torch.float64 for t in got)
    with jax.enable_x64(True):
        jnet = JSelfCollisionNet.from_npz(NPZ)
        ref_sd = np.asarray(jnet.signed_distance(jnp.asarray(q)))
        ref_g = np.asarray(jax.vmap(jax.grad(jnet.signed_distance))(
            jnp.asarray(q)))
    np.testing.assert_allclose(got[0].numpy(), ref_sd, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), ref_g, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["relu_7_32_16_1", "tanh_7_32_16_1"])
def test_save_npz_round_trips(tmp_path, kind):
    """The port's save_npz writes the reference's keys (no activation key,
    as there: a tanh net's activation is passed again on loading); it
    reloads in both packages to the same net."""
    jnet, net = _pair(kind)
    path = tmp_path / "net.npz"
    net.save_npz(path)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["W0", "b0", "W1", "b1", "W2", "b2", "mean_q", "std_q",
             "scale_out"])
        back = (SelfCollisionNet.from_npz(path, device="cpu")
                if net.activation == "relu" else SelfCollisionNet.from_arrays(
                    dict(data, activation="tanh"), "cpu"))
    assert back.activation == net.activation
    for (W, b), (W2, b2) in zip(net.weights, back.weights):
        assert torch.equal(W, W2) and torch.equal(b, b2)
    for k in ("mean_q", "std_q", "scale_out"):
        assert torch.equal(getattr(back, k), getattr(net, k))
    q = box_q(64, seed=4)
    assert torch.equal(back.raw_distance(torch.as_tensor(q)),
                       net.raw_distance(torch.as_tensor(q)))
    bundled = SelfCollisionNet.from_npz(NPZ, device="cpu")
    bundled.save_npz(tmp_path / "bundled.npz")
    again = JSelfCollisionNet.from_npz(tmp_path / "bundled.npz")
    np.testing.assert_array_equal(
        np.asarray(again.raw_distance(jnp.asarray(q))),
        np.asarray(JSelfCollisionNet.from_npz(NPZ).raw_distance(
            jnp.asarray(q))))


def test_fit_lowers_the_loss_and_labels_match_jax():
    robot = RobotPanda.create(device="cpu")
    q = box_q(512, seed=5)
    labels = self_collision_labels(robot, torch.as_tensor(q)).numpy()
    jrobot = JRobotPanda.create()
    pts = jrobot.self_collision_points(jrobot.fk_map_collision(
        jnp.asarray(q)))
    ref = -np.asarray(jnp.min(jax_self_collision_distances(
        pts, np.asarray(jrobot.self_pair_idxs)), axis=-1))
    np.testing.assert_allclose(labels, ref, rtol=0, atol=1e-6)

    # the untrained net of the same draw: fit_self_collision_net draws its
    # samples, then its initial weights, from the generator
    gen = torch.Generator().manual_seed(7)
    qs = robot.random_q(gen, 512)
    net0 = SelfCollisionNet.init(gen, 7, (32, 16), device="cpu")
    y = self_collision_labels(robot, qs)
    net0 = dataclasses.replace(net0, mean_q=qs.mean(0),
                               std_q=qs.std(0, correction=0) + 1e-6)
    loss0 = float(torch.mean(torch.square(net0.raw_distance(qs) - y)))
    net, loss = fit_self_collision_net(torch.Generator().manual_seed(7),
                                       robot, n_samples=512, hidden=(32, 16),
                                       epochs=5, batch_size=128, lr=1e-3)
    assert net.widths == (7, 32, 16, 1)
    assert torch.equal(net.mean_q, net0.mean_q)
    assert np.isfinite(loss) and loss < loss0
    full = float(torch.mean(torch.square(net.raw_distance(qs) - y)))
    assert full < loss0
