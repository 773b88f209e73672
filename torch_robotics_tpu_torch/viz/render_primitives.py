"""Matplotlib rendering of SDF primitives (counterpart of
torch_robotics_tpu/viz/render_primitives.py): spheres as circles or
surfaces, boxes as (rotated, rounded) rectangles or wire boxes; an
object's pose applied as a matplotlib affine transform in 2-D and to the
points in 3-D."""
from __future__ import annotations

import numpy as np
import torch

from ..core.utils import to_numpy


def _pose_np(pos, ori):
    """(position (3,), rotation (3, 3)) as numpy from a pose of tensors or
    arrays (None: the origin, the identity)."""
    from ..core.quaternion import q_to_rotation_matrix
    pos = np.zeros(3) if pos is None else to_numpy(pos).reshape(-1)
    if ori is None:
        return pos, np.eye(3)
    rot = q_to_rotation_matrix(torch.as_tensor(to_numpy(ori)))
    return pos, to_numpy(rot).reshape(3, 3)


def plot_sphere(ax, center, pos, radius, cmap):
    u, v = np.mgrid[0:2 * np.pi:30j, 0:np.pi:20j]
    x = radius * (np.cos(u) * np.sin(v))
    y = radius * (np.sin(u) * np.sin(v))
    z = radius * np.cos(v)
    ax.plot_surface(x + center[0] + pos[0], y + center[1] + pos[1],
                    z + center[2] + pos[2], cmap=cmap, alpha=1)


def render_spheres(spheres, ax, pos=None, ori=None, color="gray",
                   cmap="gray", **kwargs):
    import matplotlib.pyplot as plt
    pos_np, _ = _pose_np(pos, ori)
    centers = to_numpy(spheres.centers)
    radii = to_numpy(spheres.radii)
    for center, radius in zip(centers, radii):
        if getattr(ax, "name", "") == "3d":
            plot_sphere(ax, center, pos_np, float(radius), cmap)
        else:
            ax.add_patch(plt.Circle(
                (center[0] + pos_np[0], center[1] + pos_np[1]), float(radius),
                color=color, linewidth=0, alpha=1))


def _patch_rotate_translate(ax, patch, rot2, trans2):
    from matplotlib import transforms
    deg = np.rad2deg(np.arctan2(rot2[1, 0], rot2[0, 0]))
    tf = (transforms.Affine2D().rotate_deg(deg)
          .translate(trans2[0], trans2[1]) + ax.transData)
    patch.set_transform(tf)
    ax.add_patch(patch)


def render_boxes(boxes, ax, pos=None, ori=None, color="gray", cmap="gray",
                 rounding=None, **kwargs):
    import matplotlib.pyplot as plt
    from matplotlib.patches import BoxStyle, FancyBboxPatch
    pos_np, rot = _pose_np(pos, ori)
    centers = to_numpy(boxes.centers)
    sizes = to_numpy(boxes.sizes)
    if getattr(ax, "name", "") == "3d":
        for center, size in zip(centers, sizes):
            _render_box_3d(ax, center, size, rot, pos_np, cmap)
        return
    rounding_np = None if rounding is None else to_numpy(rounding)
    for i, (center, size) in enumerate(zip(centers, sizes)):
        a, b = float(size[0]), float(size[1])
        corner = (center[0] - a / 2, center[1] - b / 2)
        if rounding_np is not None:
            patch = FancyBboxPatch(
                corner, a, b, color=color,
                boxstyle=BoxStyle.Round(pad=0.0,
                                        rounding_size=float(rounding_np[i])))
        else:
            patch = plt.Rectangle(corner, a, b, color=color, linewidth=0,
                                  alpha=1)
        _patch_rotate_translate(ax, patch, rot[:2, :2], pos_np[:2])


def _render_box_3d(ax, center, size, rot, pos, cmap):
    phi = np.arange(1, 10, 2) * np.pi / 4
    Phi, Theta = np.meshgrid(phi, phi, indexing="ij")
    x = np.cos(Phi) * np.sin(Theta)
    y = np.sin(Phi) * np.sin(Theta)
    z = np.cos(Theta) / np.sqrt(2)
    pts = np.stack([center[0] + x.ravel() * size[0],
                    center[1] + y.ravel() * size[1],
                    center[2] + z.ravel() * size[2]], axis=-1)
    pts = pts @ rot.T + pos
    d = x.shape[0]
    ax.plot_surface(pts[:, 0].reshape(d, d), pts[:, 1].reshape(d, d),
                    pts[:, 2].reshape(d, d), cmap=cmap, alpha=0.25)
