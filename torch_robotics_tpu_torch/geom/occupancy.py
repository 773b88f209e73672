"""Binary occupancy grids for collision checking (counterpart of
torch_robotics_tpu/geom/occupancy.py).

The map is rasterized from the objects' SDF (a cell is occupied iff the
SDF at its center is <= 0).  Cells are centered on the workspace origin,
as in the reference: cell i of an axis has its center at (i - cmap // 2)
cell_size, and a point x falls in cell floor(x / cell_size + cmap // 2),
clamped.  Plain PyTorch on every device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["OccupancyMap", "build_occupancy_map"]


@dataclasses.dataclass(eq=False)
class OccupancyMap:
    """map: cmap_dim float32 grid of 0 / 1."""
    map: torch.Tensor
    cell_size: float = 0.01
    cmap_dim: tuple = ()

    @property
    def dim(self) -> int:
        return len(self.cmap_dim)

    @property
    def origin(self) -> np.ndarray:
        return np.array([d // 2 for d in self.cmap_dim])

    def get_collisions(self, x):
        """x (..., dim) world points -> the occupancy value of their cell
        (...)."""
        dev = x.device
        # a divisor on the device: a CUDA division by a host scalar
        # multiplies by its reciprocal, which moves points across faces
        cell = torch.tensor(self.cell_size, dtype=x.dtype, device=dev)
        offset = torch.as_tensor(self.origin, dtype=x.dtype, device=dev)
        idx = torch.floor(x / cell + offset).to(torch.int64)
        hi = torch.as_tensor(self.cmap_dim, device=dev) - 1
        idx = torch.minimum(torch.clamp(idx, min=0), hi)
        return self.map[tuple(torch.moveaxis(idx, -1, 0))]

    def compute_distances(self, x, occupied_points=None):
        """Euclidean distances from x (..., dim) to the occupied cells'
        centers -> (..., n_occupied); the centers are computed here unless
        given."""
        if occupied_points is None:
            occupied_points = torch.as_tensor(self.occupied_points(),
                                              dtype=x.dtype, device=x.device)
        return torch.linalg.norm(x[..., None, :] - occupied_points, dim=-1)

    def occupied_points(self) -> np.ndarray:
        """World coordinates (n, dim) of the occupied cells' centers, in
        'ij' order (host-side numpy)."""
        idxs = np.argwhere(self.map.cpu().numpy() > 0)
        return (idxs - self.origin) * self.cell_size

    def compute_cost(self, x):
        return self.get_collisions(x)

    def plot(self, ax=None, save_path=None):
        """2-D filled contours or 3-D voxels of the map (matplotlib, host);
        returns the axis and saves the figure when ``save_path``."""
        import matplotlib.pyplot as plt
        grid = self.map.cpu().numpy()
        if ax is None:
            if self.dim == 2:
                _, ax = plt.subplots()
            else:
                ax = plt.figure().add_subplot(projection="3d")
        if self.dim == 2:
            axes = [(np.arange(self.cmap_dim[d]) - self.origin[d])
                    * self.cell_size for d in range(2)]
            # contourf(x, y, Z) expects Z[y, x]; the grid is 'ij' indexed
            ax.contourf(axes[0], axes[1], np.clip(grid.T, 0, 1), 2,
                        cmap="Greys")
        else:
            coords = np.indices(np.array(grid.shape) + 1, dtype=float)
            coords = [(coords[d] - self.origin[d]) * self.cell_size
                      for d in range(3)]
            ax.voxels(coords[0], coords[1], coords[2], grid > 0,
                      facecolors="gray", edgecolor="black", shade=False,
                      alpha=0.05)
        if save_path is not None:
            ax.figure.savefig(save_path, dpi=120)
        return ax


def build_occupancy_map(limits, cell_size: float, obj_list,
                        chunk: int = 8192, device="cuda") -> OccupancyMap:
    """Rasterize the objects into a binary grid spanning the box
    ``limits`` (2, dim) around the origin: cmap_dim = ceil(extent /
    cell_size) per axis, cell centers at (i - cmap // 2) cell_size."""
    dev = resolve_device(device)
    lim = np.asarray(torch.as_tensor(limits).cpu(), np.float32)
    dim = lim.shape[-1]
    extent = np.abs(lim[1] - lim[0])
    cmap_dim = tuple(int(math.ceil(extent[k] / cell_size)) for k in range(dim))
    origin = [d // 2 for d in cmap_dim]
    axes = [(torch.arange(cmap_dim[k], device=dev) - origin[k]) * cell_size
            for k in range(dim)]
    points = torch.stack([m.reshape(-1) for m in
                          torch.meshgrid(*axes, indexing="ij")], dim=-1)
    occ = torch.empty(points.shape[0], dtype=torch.float32, device=dev)
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        sdf = None
        for obj in obj_list:
            v = obj.signed_distance(p)
            sdf = v if sdf is None else torch.minimum(sdf, v)
        occ[s:s + chunk] = (sdf <= 0.0).to(torch.float32)
    return OccupancyMap(map=occ.reshape(cmap_dim), cell_size=cell_size,
                        cmap_dim=cmap_dim)
