"""Small plotting helpers: coordinate frames (counterpart of
torch_robotics_tpu/viz/plot_utils.py)."""
from __future__ import annotations

from ..core.utils import to_numpy


def plot_coordinate_frame(ax, rot, trans, arrow_length=0.1, arrow_alpha=1.0,
                          arrow_linewidth=2.0):
    """Draw a frame's x, y, z axes as red, green, blue arrows from (R, t)
    or a 4 x 4 homogeneous matrix (tensors on any device or arrays)."""
    rot = to_numpy(rot)
    if rot.shape[-1] == 4:  # homogeneous matrix
        trans = rot[:3, 3]
        rot = rot[:3, :3]
    trans = to_numpy(trans).reshape(-1)
    for i, c in enumerate(["red", "green", "blue"]):
        axis = rot[:, i] * arrow_length
        if getattr(ax, "name", "") == "3d":
            ax.quiver(trans[0], trans[1], trans[2], axis[0], axis[1], axis[2],
                      color=c, alpha=arrow_alpha, linewidth=arrow_linewidth)
        else:
            ax.quiver(trans[0], trans[1], axis[0], axis[1], color=c,
                      alpha=arrow_alpha, linewidth=arrow_linewidth)
