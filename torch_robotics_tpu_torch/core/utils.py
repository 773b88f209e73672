"""Tensor utilities and the dtype policy (counterpart of
torch_robotics_tpu/core/utils.py).

The JAX package threads only a compute dtype through its constructors; the
port also names a device, and, as every constructor of the port, creates
tensors on ``"cuda"`` unless the caller asks for another device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .device import resolve_device

__all__ = ["DEFAULT_DTYPE", "DTypePolicy", "DEFAULT_POLICY", "to_torch",
           "to_numpy", "batch_cov", "batch_trace", "tensor_linspace",
           "batched_weighted_dot_prod", "MinMaxScaler", "euclidean_distance",
           "is_positive_semi_definite", "is_positive_definite",
           "torch_intersect_1d", "finite_difference_vector"]

DEFAULT_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Compute / accumulate dtype policy: ``compute`` for the bulk of the
    math, ``accum`` for reductions and factorizations."""
    compute: Any = torch.float32
    accum: Any = torch.float32


DEFAULT_POLICY = DTypePolicy()


def to_torch(x, dtype=DEFAULT_DTYPE, device="cuda") -> torch.Tensor:
    """Array-likes (numpy, lists, tensors) -> a tensor of ``dtype`` on
    ``device`` (the counterpart of the JAX package's ``to_jnp``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=resolve_device(device), dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def to_numpy(x, dtype=np.float32) -> np.ndarray:
    """Tensors (any device), numpy arrays and array-likes -> a numpy array
    of ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(dtype)
    return np.asarray(x).astype(dtype)


def batch_cov(points: torch.Tensor) -> torch.Tensor:
    """Batched covariance over (B, N, D) -> (B, D, D), unbiased for N > 1."""
    _, N, _ = points.shape
    diffs = points - points.mean(dim=1, keepdim=True)
    return torch.einsum("bni,bnj->bij", diffs, diffs) / max(N - 1, 1)


def batch_trace(covs: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1)


def tensor_linspace(start, end, steps: int = 10) -> torch.Tensor:
    """Vectorized linspace: shape start.shape + (steps,)."""
    start = torch.as_tensor(start)
    end = torch.as_tensor(end, dtype=start.dtype, device=start.device)
    w = torch.linspace(0.0, 1.0, steps, dtype=start.dtype,
                       device=start.device)
    return start[..., None] * (1.0 - w) + end[..., None] * w


def batched_weighted_dot_prod(x, M, y) -> torch.Tensor:
    """Batched x^T M y contracted over the second-to-last axis."""
    My = torch.einsum("ij,...jk->...ik", M, y)
    return torch.einsum("...ij,...ij->...j", x, My)


class MinMaxScaler:
    """Scale values to [0, 1] by (x - min) / (max - min); min and max are
    taken from the first tensor seen unless provided."""

    def __init__(self, min=None, max=None, dim=None):
        self.min = min
        self.max = max
        self.dim = dim

    def scale(self, X: torch.Tensor) -> torch.Tensor:
        if self.min is None:
            self.min = (torch.min(X) if self.dim is None
                        else torch.amin(X, dim=self.dim))
        if self.max is None:
            self.max = (torch.max(X) if self.dim is None
                        else torch.amax(X, dim=self.dim))
        return (X - self.min) / (self.max - self.min)


def euclidean_distance(x_batch, x_target, w_pos=1.0,
                       normalized_input=False) -> torch.Tensor:
    """Weighted Euclidean distance over the last axis."""
    if normalized_input:
        x_batch = MinMaxScaler(dim=-2).scale(x_batch)
        x_target = MinMaxScaler(dim=-2).scale(x_target)
    return w_pos * torch.linalg.vector_norm(x_batch - x_target, dim=-1)


def is_positive_semi_definite(mat) -> bool:
    """Host-side check: symmetric with eigenvalues >= 0."""
    m = to_numpy(mat, np.float64)
    return bool(np.allclose(m, m.T)
                and (np.linalg.eigvals(m).real >= 0).all())


def is_positive_definite(mat) -> bool:
    m = to_numpy(mat, np.float64)
    return bool(np.allclose(m, m.T) and (np.linalg.eigvals(m).real > 0).all())


def torch_intersect_1d(a, b) -> torch.Tensor:
    """Sorted intersection of two 1-D integer tensors (host-side: the
    result's size depends on the data), on ``a``'s device."""
    a = torch.as_tensor(a)
    common = np.intersect1d(a.cpu().numpy(), torch.as_tensor(b).cpu().numpy())
    return torch.as_tensor(common, device=a.device)


def finite_difference_vector(x, dt=1.0, method="forward") -> torch.Tensor:
    """Finite differences along axis -2 with zero padding at the borders
    ("forward", "backward" or "central")."""
    x = torch.as_tensor(x)
    zeros_one = torch.zeros_like(x[..., :1, :])
    if method == "forward":
        d = (x[..., 1:, :] - x[..., :-1, :]) / dt
        return torch.cat([d, zeros_one], dim=-2)
    if method == "backward":
        d = (x[..., 1:, :] - x[..., :-1, :]) / dt
        return torch.cat([zeros_one, d], dim=-2)
    if method == "central":
        d = (x[..., 2:, :] - x[..., :-2, :]) / (2.0 * dt)
        return torch.cat([zeros_one, d, zeros_one], dim=-2)
    raise NotImplementedError(method)
