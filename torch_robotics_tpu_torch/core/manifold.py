"""Product manifolds R^n x (S^3)^m with Gaussians (counterpart of
torch_robotics_tpu/core/manifold.py).

A point is a flat vector with its factors' coordinates concatenated (wxyz
for a quaternion factor); a tangent vector likewise, with 3 coordinates a
quaternion factor.  Every map is batched over leading dims.  The Karcher
mean is a fixed number of gradient steps on the manifold; a Gaussian is a
mean point with a covariance in the tangent space at it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .euclidean import e_exp_map, e_log_map, e_parallel_transport
from .quaternion import q_exp_map, q_log_map, q_parallel_transport

__all__ = ["Manifold", "get_manifold_from_name", "Gaussian",
           "kl_divergence_mvn"]


@dataclasses.dataclass(frozen=True)
class _Factor:
    kind: str          # 'euclidean' | 'quaternion'
    dim_M: int         # ambient dimension (n or 4)
    dim_T: int         # tangent dimension (n or 3)


_MAPS = {"euclidean": (e_log_map, e_exp_map, e_parallel_transport),
         "quaternion": (q_log_map, q_exp_map, q_parallel_transport)}


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Product manifold, its factors laid out contiguously in a point."""
    factors: Tuple[_Factor, ...]

    @classmethod
    def euclidean(cls, n: int) -> "Manifold":
        return cls((_Factor("euclidean", n, n),))

    @classmethod
    def sphere_S3(cls) -> "Manifold":
        return cls((_Factor("quaternion", 4, 3),))

    def cartesian_product(self, other: "Manifold") -> "Manifold":
        return Manifold(self.factors + other.factors)

    @property
    def dim_M(self) -> int:
        return sum(f.dim_M for f in self.factors)

    @property
    def dim_T(self) -> int:
        return sum(f.dim_T for f in self.factors)

    def _split(self, x, ambient=True):
        if x is None:
            return [None] * len(self.factors)
        out, i = [], 0
        for f in self.factors:
            n = f.dim_M if ambient else f.dim_T
            out.append(x[..., i:i + n])
            i += n
        return out

    def log_map(self, x: torch.Tensor, base=None) -> torch.Tensor:
        """Point (..., dim_M) -> tangent (..., dim_T) at ``base`` (the
        origin if None)."""
        return torch.cat([_MAPS[f.kind][0](xi, bi) for f, xi, bi in zip(
            self.factors, self._split(x), self._split(base))], dim=-1)

    def exp_map(self, v: torch.Tensor, base=None) -> torch.Tensor:
        """Tangent (..., dim_T) at ``base`` -> point (..., dim_M)."""
        return torch.cat([_MAPS[f.kind][1](vi, bi) for f, vi, bi in zip(
            self.factors, self._split(v, ambient=False),
            self._split(base))], dim=-1)

    def parallel_transport(self, v: torch.Tensor, g: torch.Tensor,
                           h: torch.Tensor) -> torch.Tensor:
        """Tangent v (..., dim_T) at g -> at h."""
        return torch.cat([_MAPS[f.kind][2](vi, gi, hi) for f, vi, gi, hi
                          in zip(self.factors, self._split(v, ambient=False),
                                 self._split(g), self._split(h))], dim=-1)

    def mean(self, points: torch.Tensor, n_iters: int = 20,
             step: float = 1.0) -> torch.Tensor:
        """Karcher mean of points (N, dim_M): ``n_iters`` gradient steps on
        the manifold from the first point."""
        mu = points[0]
        for _ in range(n_iters):
            v = self.log_map(points, base=mu)
            mu = self.exp_map(step * v.mean(dim=0), base=mu)
        return mu

    def normal_distribution(self, mean, cov) -> "Gaussian":
        return Gaussian(self, mean, cov)


def get_manifold_from_name(name: str) -> Manifold:
    """'euclidean' / 'R', 'S3' / 'quaternion' / 'sphere', or 'R^n'."""
    if name in ("euclidean", "R"):
        return Manifold.euclidean(1)
    if name in ("S3", "quaternion", "sphere"):
        return Manifold.sphere_S3()
    if name.startswith("R^"):
        return Manifold.euclidean(int(name[2:]))
    raise NotImplementedError(name)


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Gaussian on a manifold: a mean point (dim_M,) and a covariance
    (dim_T, dim_T) in the tangent space at it."""
    manifold: Manifold
    mean: torch.Tensor
    cov: torch.Tensor

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        v = self.manifold.log_map(x, base=self.mean)
        k = self.manifold.dim_T
        quad = torch.einsum("...i,ij,...j->...", v,
                            torch.linalg.inv(self.cov), v)
        norm = torch.sqrt((2 * math.pi) ** k * torch.linalg.det(self.cov))
        return torch.exp(-0.5 * quad) / norm

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """n points (n, dim_M): exp_mean(L z) with L the covariance's
        Cholesky factor and z (n, dim_T) standard normals, drawn from
        ``generator`` on the mean's device unless given."""
        L = torch.linalg.cholesky(self.cov)
        if z is None:
            z = torch.randn((n, self.manifold.dim_T), generator=generator,
                            dtype=self.mean.dtype, device=self.mean.device)
        return self.manifold.exp_map(z @ L.T, base=self.mean)

    def transform(self, A: torch.Tensor, b=None) -> "Gaussian":
        """Affine map in the tangent space at the origin."""
        v = (A @ self.manifold.log_map(self.mean)[..., None])[..., 0]
        new_mean = self.manifold.exp_map(v if b is None else v + b)
        return Gaussian(self.manifold, new_mean, A @ self.cov @ A.T)

    def prod(self, other: "Gaussian") -> "Gaussian":
        """Product of Gaussians in the tangent space at self.mean."""
        P1 = torch.linalg.inv(self.cov)
        P2 = torch.linalg.inv(other.cov)
        cov = torch.linalg.inv(P1 + P2)
        v2 = self.manifold.log_map(other.mean, base=self.mean)
        v = (cov @ (P2 @ v2[..., None]))[..., 0]
        return Gaussian(self.manifold,
                        self.manifold.exp_map(v, base=self.mean), cov)


def kl_divergence_mvn(g1: Gaussian, g2: Gaussian) -> torch.Tensor:
    """KL(g1 || g2) in the tangent space at g1's mean."""
    k = g1.manifold.dim_T
    cov2_inv = torch.linalg.inv(g2.cov)
    dm = g1.manifold.log_map(g2.mean, base=g1.mean)
    term_tr = torch.trace(cov2_inv @ g1.cov)
    term_quad = dm @ cov2_inv @ dm
    term_logdet = (torch.linalg.slogdet(g2.cov)[1]
                   - torch.linalg.slogdet(g1.cov)[1])
    return 0.5 * (term_tr + term_quad - k + term_logdet)
