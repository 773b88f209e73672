"""Precomputed voxel SDF grids with nearest-cell and trilinear lookups
(counterpart of torch_robotics_tpu/geom/grid_sdf.py).

The layout and lookups are the reference's, bit for bit where they can be:

- ``cmap_dim = ceil(extent / cell_size)`` with the extent taken in
  float32, nodes at inclusive ``linspace``s of the limits, 'ij' indexed;
- the nearest lookup's cell index is ``floor((x - lim0) / extent * cmap)``
  per axis, clamped to [0, cmap - 1] (true division, in that order).  It
  does not match the nodes' ``extent / (cmap - 1)`` spacing: that is the
  reference's semantics, kept;
- the nearest lookup's value is the cell's SDF and its derivative in x the
  cell's gradient (the surrogate sdf(x_cell) + (x - stop_grad(x)) .
  grad(x_cell)).

The precompute evaluates the min-over-objects SDF and its analytic
gradient (``ops/lanes_fk.sdf_and_grad_lanes``) at the nodes in chunks; it
needs no kernel (the JAX package runs it as plain XLA).  ``table()`` is
the grid as the CUDA terms and cost kernels read it: one (C, 4) float32
row (sdf, gx, gy, gz) per cell, 16-byte aligned, built once a grid.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["GridSDF", "precompute_sdf_grid"]


def precompute_sdf_grid(limits, cell_size: float, obj_list, chunk: int = 8192,
                        device="cuda") -> "GridSDF":
    """A GridSDF of the objects' min SDF over the box ``limits`` (2, dim):
    cmap_dim = ceil(extent / cell_size) nodes per axis at inclusive
    linspaces, 'ij' indexed; the SDF and its gradient at the nodes,
    ``chunk`` nodes at a time."""
    from ..ops.lanes_fk import sdf_and_grad_lanes
    dev = resolve_device(device)
    lim = np.asarray(torch.as_tensor(limits).cpu(), np.float32)
    dim = lim.shape[-1]
    extent = np.abs(lim[1] - lim[0])                    # float32, as JAX's
    cmap_dim = tuple(int(math.ceil(float(extent[k]) / cell_size))
                     for k in range(dim))
    lim_t = torch.as_tensor(lim, device=dev)
    axes = [torch.linspace(lim[0, k], lim[1, k], cmap_dim[k],
                           dtype=torch.float32, device=dev)
            for k in range(dim)]
    points = torch.stack([m.reshape(-1) for m in
                          torch.meshgrid(*axes, indexing="ij")])  # (dim, C)
    n = points.shape[1]
    sdf = torch.empty(n, dtype=torch.float32, device=dev)
    grad = torch.empty((dim, n), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        sdf[s:s + chunk], grad[:, s:s + chunk] = sdf_and_grad_lanes(
            obj_list, points[:, s:s + chunk])
    return GridSDF(limits=lim_t, sdf_grid=sdf.reshape(cmap_dim),
                   grad_grid=grad.T.reshape(cmap_dim + (dim,)).contiguous(),
                   cmap_dim=cmap_dim)


@dataclasses.dataclass(eq=False)
class GridSDF:
    """Voxel SDF and gradient grid over a box workspace: limits (2, dim),
    sdf_grid cmap_dim, grad_grid cmap_dim + (dim,), all float32 on one
    device."""
    limits: torch.Tensor
    sdf_grid: torch.Tensor
    grad_grid: torch.Tensor
    cmap_dim: tuple = ()
    _table: torch.Tensor = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(cls, limits, sdf_grid, grad_grid, cmap_dim=None,
               device="cuda") -> "GridSDF":
        """A grid from array-likes (numpy or tensors), as float32 on
        ``device``; cmap_dim defaults to sdf_grid's shape."""
        dev = resolve_device(device)

        def f32(a):
            a = a.detach().cpu() if torch.is_tensor(a) else a
            return torch.as_tensor(np.array(a, np.float32), device=dev)
        sdf = f32(sdf_grid)
        return cls(limits=f32(limits), sdf_grid=sdf,
                   grad_grid=f32(grad_grid),
                   cmap_dim=tuple(int(c) for c in (
                       sdf.shape if cmap_dim is None else cmap_dim)))

    @property
    def dim(self) -> int:
        return self.limits.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.sdf_grid.device

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cmap_dim))

    def _scaled(self, x):
        """(x - lim0) / extent * cmap per axis: the reference's cell
        coordinate, in x's dtype (...)."""
        extent = torch.abs(self.limits[1] - self.limits[0])
        cmap = torch.as_tensor(self.cmap_dim, dtype=x.dtype, device=x.device)
        return (x - self.limits[0]) / extent * cmap

    def _cell_index(self, x):
        """Reference cell indexing (grid_map_sdf.py:93-97), clamped:
        x (..., dim) -> (..., dim) int64."""
        hi = torch.as_tensor(self.cmap_dim, device=x.device) - 1
        idx = torch.floor(self._scaled(x)).to(torch.int64)
        return torch.minimum(torch.clamp(idx, min=0), hi)

    def _flat_index(self, x):
        """x (..., dim) -> the 'ij' flat index of its cell (...)."""
        idx = self._cell_index(x)
        flat = idx[..., 0]
        for k in range(1, self.dim):
            flat = flat * self.cmap_dim[k] + idx[..., k]
        return flat

    def near_face(self, x, tol: float = 1e-4):
        """x (..., dim) -> bool (...): the point lies within ``tol`` cell
        widths of a cell face on some axis, where float32 rounding of x can
        move it into the next cell."""
        c = self._scaled(x)
        return (torch.abs(c - torch.round(c)) < tol).any(-1)

    def signed_distance(self, x):
        """Nearest-cell lookup: value the cell's SDF, derivative in x the
        cell's gradient.  x (..., dim) -> (...)."""
        flat = self._flat_index(x.detach())
        sdf = self.sdf_grid.reshape(-1)[flat].to(x.dtype)
        grad = self.grad_grid.reshape(-1, self.dim)[flat].to(x.dtype)
        return sdf + torch.sum((x - x.detach()) * grad, dim=-1)

    def signed_distance_trilinear(self, x):
        """Multilinear interpolation of the SDF over the nodes (node i of
        an axis at lim0 + i extent / (cmap - 1)): smooth value and
        gradient.  x (..., dim) -> (...)."""
        extent = torch.abs(self.limits[1] - self.limits[0])
        cmap = torch.as_tensor(self.cmap_dim, dtype=x.dtype, device=x.device)
        coord = (x - self.limits[0]) / extent * (cmap - 1.0)
        coord = torch.minimum(torch.clamp(coord, min=0.0), cmap - 1.0)
        hi = torch.as_tensor(self.cmap_dim, device=x.device) - 2
        i0 = torch.minimum(torch.clamp(torch.floor(coord).to(torch.int64),
                                       min=0), hi)
        frac = coord - i0.to(x.dtype)
        flat_sdf = self.sdf_grid.reshape(-1).to(x.dtype)
        out = 0.0
        for corner in range(2 ** self.dim):
            offs = [(corner >> k) & 1 for k in range(self.dim)]
            idx = i0 + torch.as_tensor(offs, device=x.device)
            w = torch.ones_like(frac[..., 0])
            flat = idx[..., 0]
            for k in range(self.dim):
                w = w * (frac[..., k] if offs[k] else 1.0 - frac[..., k])
                if k:
                    flat = flat * self.cmap_dim[k] + idx[..., k]
            out = out + w * flat_sdf[flat]
        return out

    def table(self) -> torch.Tensor:
        """The kernels' copy of the grid: (C, 4) float32 rows (sdf, gx, gy,
        gz) in 'ij' flat order (a 2-D grid's gz is 0), contiguous, so a
        cell is one 16-byte load.  Built at the first call, then kept."""
        if self._table is None:
            C, dim = self.n_cells, self.dim
            t = torch.zeros((C, 4), dtype=torch.float32, device=self.device)
            t[:, 0] = self.sdf_grid.reshape(-1)
            t[:, 1:1 + dim] = self.grad_grid.reshape(C, dim)
            self._table = t
        return self._table

    # reference-compatible aliases (grid_map_sdf.py:75-82)
    def __call__(self, x):
        return self.signed_distance(x)

    def compute_signed_distance(self, x):
        return self.signed_distance(x)

    def compute_cost(self, x):
        return self.signed_distance(x)
