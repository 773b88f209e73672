"""Analytic signed-distance primitives and posed composite objects
(counterpart of torch_robotics_tpu/geom/sdf.py).

Primitive groups hold packed tensors (all spheres of an object in one
(n, dim) tensor, etc.); every SDF is a batched function of query points
``x: (..., dim) -> (...,)`` with the reference's math:

- spheres: min_j ||x - c_j|| - r_j
- sharp boxes: min_j max_i (|x - c_j| - h_j)_i
- rounded boxes (the ``MultiBoxField`` default): rounded rect with radius
  0.15 * min(size)
- ``ObjectField``: min over member groups after pulling the query back into
  the object frame.

Precomputed grids are ``geom/grid_sdf.py``, occupancy maps
``geom/occupancy.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.pytrees import safe_norm
from ..core.quaternion import q_to_rotation_matrix
from ..core.se3 import rotate_point

__all__ = ["Spheres", "SharpBoxes", "RoundedBoxes", "ObjectField",
           "MultiSphereField", "MultiSharpBoxField", "MultiBoxField"]


@dataclasses.dataclass(frozen=True)
class Spheres:
    """A group of spheres: centers (n, dim), radii (n,)."""
    centers: torch.Tensor
    radii: torch.Tensor

    @property
    def dim(self) -> int:
        return self.centers.shape[-1]

    def signed_distance(self, x):
        d = safe_norm(x[..., None, :] - self.centers, dim=-1)
        return torch.amin(d - self.radii, dim=-1)

    def render(self, ax, pos=None, ori=None, color="gray", cmap="gray",
               **kw):
        from ..viz.render_primitives import render_spheres
        render_spheres(self, ax, pos=pos, ori=ori, color=color, cmap=cmap,
                       **kw)


@dataclasses.dataclass(frozen=True)
class SharpBoxes:
    """Axis-aligned boxes with the max-norm SDF: centers (n, dim),
    half_sizes (n, dim)."""
    centers: torch.Tensor
    half_sizes: torch.Tensor

    @property
    def dim(self) -> int:
        return self.centers.shape[-1]

    @property
    def sizes(self) -> torch.Tensor:
        return 2.0 * self.half_sizes

    def signed_distance(self, x):
        d = torch.abs(x[..., None, :] - self.centers) - self.half_sizes
        return torch.amin(torch.amax(d, dim=-1), dim=-1)

    def render(self, ax, pos=None, ori=None, color="gray", cmap="gray",
               **kw):
        from ..viz.render_primitives import render_boxes
        render_boxes(self, ax, pos=pos, ori=ori, color=color, cmap=cmap, **kw)


@dataclasses.dataclass(frozen=True)
class RoundedBoxes:
    """Rounded boxes: centers (n, dim), half_sizes (n, dim), round_radii (n,)
    (0.15 * min(size) per box from ``from_sizes``)."""
    centers: torch.Tensor
    half_sizes: torch.Tensor
    round_radii: torch.Tensor

    @classmethod
    def from_sizes(cls, centers, sizes):
        return cls(centers, sizes / 2.0, torch.amin(sizes, dim=-1) * 0.15)

    @property
    def dim(self) -> int:
        return self.centers.shape[-1]

    @property
    def sizes(self) -> torch.Tensor:
        return 2.0 * self.half_sizes

    def signed_distance(self, x):
        q = (torch.abs(x[..., None, :] - self.centers) - self.half_sizes
             + self.round_radii[..., None])
        max_q = torch.amax(q, dim=-1)
        sdfs = (torch.clamp(max_q, max=0.0)
                + safe_norm(torch.relu(q), dim=-1) - self.round_radii)
        return torch.amin(sdfs, dim=-1)

    def render(self, ax, pos=None, ori=None, color="gray", cmap="gray",
               **kw):
        from ..viz.render_primitives import render_boxes
        render_boxes(self, ax, pos=pos, ori=ori, color=color, cmap=cmap,
                     rounding=self.round_radii, **kw)


@dataclasses.dataclass(frozen=True)
class ObjectField:
    """A posed composite of primitive groups: pos (3,), ori wxyz (4,).
    Queries are pulled back into the object frame first; 2-D queries are
    lifted with z = 0."""
    fields: tuple
    pos: torch.Tensor
    ori: torch.Tensor
    name: str = "object"

    @classmethod
    def create(cls, fields: Sequence, name="object", pos=None, ori=None,
               device="cuda"):
        dev = resolve_device(device)
        pos = np.zeros(3) if pos is None else np.asarray(pos)
        ori = np.array([1.0, 0, 0, 0]) if ori is None else np.asarray(ori)
        return cls(tuple(fields),
                   torch.as_tensor(pos, dtype=torch.float32, device=dev),
                   torch.as_tensor(ori, dtype=torch.float32, device=dev),
                   name=name)

    @property
    def dim(self) -> int:
        return self.fields[0].dim

    def with_pose(self, pos=None, ori=None) -> "ObjectField":
        """The same fields at another pose: pos (3,), ori wxyz (4,), each
        cast to the current pose's dtype and device (None keeps it).  A
        task built from the new object packs the new pose into the
        kernels' scene buffers."""
        def cast(a, like):
            a = a.detach() if torch.is_tensor(a) else np.asarray(a)
            return torch.as_tensor(a, dtype=like.dtype, device=like.device)
        return dataclasses.replace(
            self, pos=self.pos if pos is None else cast(pos, self.pos),
            ori=self.ori if ori is None else cast(ori, self.ori))

    def rotation_matrix(self) -> torch.Tensor:
        return q_to_rotation_matrix(self.ori)

    def _to_object_frame(self, x):
        dim = x.shape[-1]
        if dim == 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = rotate_point(x - self.pos, self.rotation_matrix().to(x.dtype).T)
        return x[..., :2] if dim == 2 else x

    def signed_distance(self, x):
        """x: (..., dim) in the world frame -> (...,) min over groups."""
        x_obj = self._to_object_frame(x)
        sdf = None
        for f in self.fields:
            s = f.signed_distance(x_obj)
            sdf = s if sdf is None else torch.minimum(sdf, s)
        return sdf

    def compute_signed_distance(self, x):
        """The reference's name for ``signed_distance``."""
        return self.signed_distance(x)

    def render(self, ax, pos=None, ori=None, color="gray", **kw):
        """Draw every group at the object's pose (or ``pos`` / ``ori``) on
        a matplotlib axis (``viz/render_primitives.py``)."""
        pos = self.pos if pos is None else pos
        ori = self.ori if ori is None else ori
        for f in self.fields:
            f.render(ax, pos=pos, ori=ori, color=color, **kw)


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=resolve_device(device))


def MultiSphereField(centers, radii, device="cuda"):
    return Spheres(_tensor(centers, device), _tensor(radii, device))


def MultiSharpBoxField(centers, sizes, device="cuda"):
    return SharpBoxes(_tensor(centers, device), _tensor(sizes, device) / 2.0)


def MultiBoxField(centers, sizes, device="cuda"):
    """Rounded boxes (the reference's default box field)."""
    return RoundedBoxes.from_sizes(_tensor(centers, device),
                                   _tensor(sizes, device))
