"""Grasped objects: primitives attached to the end-effector with collision
base points (counterpart of torch_robotics_tpu/geom/objects.py).

A grasped object is a posed ObjectField (its pose relative to the hand
link) plus a set of base collision points (box vertices and face centres)
that the robot's FK carries into the world frame.  ``render`` draws the
object field (``viz/render_primitives.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from .sdf import MultiBoxField, ObjectField

__all__ = ["GraspedObject", "GraspedObjectPandaBox"]


@dataclasses.dataclass(frozen=True)
class GraspedObject:
    """Object field + collision base points (G, 3), posed in the frame of
    ``reference_frame``."""
    object_field: ObjectField
    base_points_for_collision: torch.Tensor   # (G, 3) in the object frame
    reference_frame: str = "panda_hand"

    @property
    def pos(self) -> torch.Tensor:
        return self.object_field.pos

    @property
    def ori(self) -> torch.Tensor:
        return self.object_field.ori

    @property
    def n_base_points_for_collision(self) -> int:
        return self.base_points_for_collision.shape[0]

    def render(self, ax, pos=None, ori=None, color="gray", **kw):
        self.object_field.render(ax, pos=pos, ori=ori, color=color, **kw)


def _box_collision_points(size, device="cuda") -> torch.Tensor:
    """The 8 vertices and 6 face centres of an axis-aligned box of ``size``
    centred at the origin, float32 (14, 3)."""
    x, y, z = (float(s) for s in size)
    vertices = np.array([
        [x / 2, y / 2, -z / 2], [x / 2, -y / 2, -z / 2],
        [-x / 2, -y / 2, -z / 2], [-x / 2, y / 2, -z / 2],
        [x / 2, y / 2, z / 2], [x / 2, -y / 2, z / 2],
        [-x / 2, -y / 2, z / 2], [-x / 2, y / 2, z / 2],
    ])
    faces = np.array([
        [x / 2, 0, 0], [0, -y / 2, 0], [-x / 2, 0, 0],
        [0, y / 2, 0], [0, 0, z / 2], [0, 0, -z / 2],
    ])
    return torch.as_tensor(np.concatenate([vertices, faces]),
                           dtype=torch.float32, device=resolve_device(device))


def GraspedObjectPandaBox(size=(0.05, 0.05, 0.15),
                          device="cuda") -> GraspedObject:
    """A box grasped by the Panda hand: 0.11 m along the hand's z-axis,
    rotated 90 degrees about y."""
    boxes = MultiBoxField(np.zeros((1, 3)), np.asarray([size]),
                          device=device)
    field = ObjectField.create(
        [boxes], name="GraspedObjectPandaBox",
        pos=np.asarray([0.0, 0.0, 0.11], np.float32),
        ori=np.asarray([0.0, 0.7071081, 0.0, 0.7071055], np.float32),
        device=device)
    return GraspedObject(object_field=field,
                         base_points_for_collision=_box_collision_points(
                             size, device),
                         reference_frame="panda_hand")
