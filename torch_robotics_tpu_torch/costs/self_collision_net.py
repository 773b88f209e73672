"""Learned self-collision signed-distance field (STORM-style; counterpart of
torch_robotics_tpu/costs/self_collision_net.py).

An MLP maps q to the raw self-collision distance, positive when
penetrating; ``signed_distance`` negates it, and the occupancy check uses
the reference's -0.05 threshold.  Weights load from, and save to, the npz
keys of the JAX package (W0, b0, W1, b1, ..., mean_q, std_q, scale_out),
so the bundled ``panda_self_collision_net.npz`` is read in place; or they
are fitted to FK-derived labels by ``fit_self_collision_net``.

Every evaluation follows its input's dtype and device: the weights are cast
to them, so a float64 CPU run evaluates a float32 checkpoint in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .fields import self_collision_distances

__all__ = ["SelfCollisionNet", "fit_self_collision_net",
           "self_collision_labels"]

_ACTIVATIONS = ("relu", "tanh")


@dataclasses.dataclass(frozen=True)
class SelfCollisionNet:
    """MLP q -> scalar raw self-collision distance (positive = penetrating).

    ``weights`` is a tuple of (W (n_in, n_out), b (n_out,)) per layer; the
    hidden layers take ``activation`` ("relu" or "tanh"), the last none."""
    weights: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    mean_q: torch.Tensor              # input normalization
    std_q: torch.Tensor
    scale_out: torch.Tensor           # output de-normalization (scale, shift)
    activation: str = "relu"

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError("activation must be one of %s, got %r"
                             % (_ACTIVATIONS, self.activation))

    @classmethod
    def init(cls, generator: torch.Generator, n_joints: int,
             hidden: Sequence[int] = (256, 64), dtype=torch.float32,
             device="cuda") -> "SelfCollisionNet":
        """He-normal weights drawn from ``generator`` (on its device, then
        moved), zero biases, identity normalization and output scale."""
        dev = resolve_device(device)
        sizes = [n_joints, *hidden, 1]
        weights = []
        for n_in, n_out in zip(sizes[:-1], sizes[1:]):
            W = torch.randn((n_in, n_out), generator=generator, dtype=dtype,
                            device=generator.device) * np.sqrt(2.0 / n_in)
            weights.append((W.to(dev), torch.zeros(n_out, dtype=dtype,
                                                   device=dev)))
        return cls(weights=tuple(weights),
                   mean_q=torch.zeros(n_joints, dtype=dtype, device=dev),
                   std_q=torch.ones(n_joints, dtype=dtype, device=dev),
                   scale_out=torch.tensor([1.0, 0.0], dtype=dtype,
                                          device=dev))

    @classmethod
    def from_arrays(cls, arrays, device="cuda") -> "SelfCollisionNet":
        """From a mapping with the npz keys (and optionally ``activation``)."""
        dev = resolve_device(device)
        n_layers = sum(1 for k in arrays if str(k).startswith("W"))

        def t(a):
            return torch.as_tensor(np.array(a), device=dev)

        return cls(weights=tuple((t(arrays["W%d" % i]), t(arrays["b%d" % i]))
                                 for i in range(n_layers)),
                   mean_q=t(arrays["mean_q"]), std_q=t(arrays["std_q"]),
                   scale_out=t(arrays["scale_out"]),
                   activation=str(arrays.get("activation", "relu")))

    @classmethod
    def from_npz(cls, path, device="cuda") -> "SelfCollisionNet":
        """Load weights exported to npz: W0, b0, W1, b1, ..., mean_q, std_q,
        scale_out."""
        with np.load(path) as data:
            return cls.from_arrays({k: data[k] for k in data.files}, device)

    def arrays(self) -> dict:
        """The npz keys as numpy arrays, plus ``activation``."""
        out = {}
        for i, (W, b) in enumerate(self.weights):
            out["W%d" % i] = W.detach().cpu().numpy()
            out["b%d" % i] = b.detach().cpu().numpy()
        for k in ("mean_q", "std_q", "scale_out"):
            out[k] = getattr(self, k).detach().cpu().numpy()
        out["activation"] = self.activation
        return out

    def save_npz(self, path) -> None:
        out = self.arrays()
        del out["activation"]         # the reference's npz has no such key
        np.savez(path, **out)

    @property
    def widths(self) -> Tuple[int, ...]:
        """(n_joints, hidden..., 1)."""
        return (int(self.weights[0][0].shape[0]),) + tuple(
            int(W.shape[1]) for W, _ in self.weights)

    def _cast(self, q):
        return [(W.to(q.device, q.dtype), b.to(q.device, q.dtype))
                for W, b in self.weights]

    def _act(self, x):
        return torch.relu(x) if self.activation == "relu" else torch.tanh(x)

    def raw_distance(self, q):
        """q (..., n_joints) -> raw net output (...)."""
        x = (q - self.mean_q.to(q)) / self.std_q.to(q)
        layers = self._cast(q)
        for W, b in layers[:-1]:
            x = self._act(x @ W + b)
        W, b = layers[-1]
        x = (x @ W + b)[..., 0]
        s = self.scale_out.to(q)
        return x * s[0] + s[1]

    def signed_distance(self, q):
        """Reference sign convention: the negated raw prediction."""
        return -self.raw_distance(q)

    def signed_distance_and_grad(self, q):
        """q (..., n_joints) -> (signed distance (...), its gradient
        (..., n_joints)), the gradient by the explicit backward chain:
        delta_L = w_L * act'(h_L), delta_l = (W_{l+1} delta_{l+1}) *
        act'(h_l), grad = -scale (W_1 delta_1) / std, where act' is
        [h > 0] (relu'(0) = 0) or 1 - h^2 (tanh) on the stored activation."""
        std = self.std_q.to(q)
        x = (q - self.mean_q.to(q)) / std
        layers = self._cast(q)
        hs = []
        for W, b in layers[:-1]:
            x = self._act(x @ W + b)
            hs.append(x)
        W, b = layers[-1]
        s = self.scale_out.to(q)
        sd = -((x @ W + b)[..., 0] * s[0] + s[1])
        delta = W[:, 0]
        for li in range(len(hs) - 1, -1, -1):
            h = hs[li]
            d_act = (h > 0).to(h.dtype) if self.activation == "relu" \
                else 1.0 - h * h
            delta = delta * d_act
            delta = delta @ layers[li][0].T
        return sd, -s[0] * delta / std

    def collision(self, q, threshold: float = -0.05):
        return self.signed_distance(q) < threshold

    def cost(self, q):
        """'sdf'-type cost: the margin-free negated distance."""
        return -self.signed_distance(q)


def self_collision_labels(robot, q):
    """Fitting labels: raw = -(min self-pair distance) of q (..., d), so
    positive means penetrating."""
    pts = robot.self_collision_points(robot.fk_map_collision(q))
    d = self_collision_distances(pts, np.asarray(robot.self_pair_idxs))
    return -torch.amin(d, dim=-1)


def fit_self_collision_net(generator: torch.Generator, robot,
                           n_samples: int = 20000, hidden=(256, 64),
                           epochs: int = 200, batch_size: int = 2048,
                           lr: float = 1e-3):
    """Train a SelfCollisionNet on FK-derived min pair distances
    (``self_collision_labels``) with Adam; each epoch is one pass over the
    shuffled samples in whole minibatches.  Returns (net, final_loss), the
    loss of the last minibatch."""
    qs = robot.random_q(generator, n_samples)
    labels = self_collision_labels(robot, qs)
    net = SelfCollisionNet.init(generator, robot.q_dim, hidden,
                                dtype=qs.dtype, device=qs.device)
    net = dataclasses.replace(net, mean_q=qs.mean(0),
                              std_q=qs.std(0, correction=0) + 1e-6)
    params = [p.clone().requires_grad_(True)
              for layer in net.weights for p in layer]
    opt = torch.optim.Adam(params, lr=lr)
    n_batches = max(1, n_samples // batch_size)
    n_used = n_batches * batch_size

    def with_params():
        return dataclasses.replace(net, weights=tuple(
            (params[2 * i], params[2 * i + 1])
            for i in range(len(net.weights))))

    loss = torch.tensor(float("inf"))
    for _ in range(epochs):
        idx = torch.randperm(n_samples, generator=generator,
                             device=generator.device)[:n_used].to(qs.device)
        for k in range(n_batches):
            sel = idx[k * batch_size:(k + 1) * batch_size]
            with torch.enable_grad():
                pred = with_params().raw_distance(qs[sel])
                loss = torch.mean(torch.square(pred - labels[sel]))
                opt.zero_grad()
                loss.backward()
            opt.step()
    fitted = with_params()
    fitted = dataclasses.replace(fitted, weights=tuple(
        (W.detach(), b.detach()) for W, b in fitted.weights))
    return fitted, float(loss.detach())
