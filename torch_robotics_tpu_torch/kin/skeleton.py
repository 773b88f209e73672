"""Skeleton: link-frame graph utilities for visualization and distances
(counterpart of torch_robotics_tpu/kin/skeleton.py).

The compiled KinematicModel already stores the parent structure, so a
skeleton is (names, parent edges, link positions), held host-side in
numpy as the JAX package holds it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.utils import to_numpy
from .fk import fk_rot_trans
from .model import KinematicModel

__all__ = ["Skeleton", "get_skeleton_from_model",
           "get_skeleton_from_landmarks"]


@dataclasses.dataclass
class Skeleton:
    link_names: Sequence[str]
    parent_idx: Sequence[int]
    positions: np.ndarray            # (n_links, 3)
    variances: Optional[np.ndarray] = None   # (n_links,) posture variance

    @property
    def edges(self):
        return [(p, i) for i, p in enumerate(self.parent_idx) if p >= 0]

    def link_lengths(self):
        out = {}
        for p, i in self.edges:
            out[(self.link_names[p], self.link_names[i])] = float(
                np.linalg.norm(self.positions[i] - self.positions[p]))
        return out

    def compute_self_distance(self):
        """All-pairs link-frame distances (n, n)."""
        d = self.positions[:, None, :] - self.positions[None, :, :]
        return np.linalg.norm(d, axis=-1)

    def sample_posture(self, generator: torch.Generator,
                       batch_size: int) -> torch.Tensor:
        """Node positions ~ N(pos, var * I) per node, drawn from
        ``generator`` on its device -> (batch, n_links, dim) float32."""
        var = (self.variances if self.variances is not None
               else np.full((len(self.link_names),), 1e-3))
        dev = generator.device
        std = torch.sqrt(torch.as_tensor(var, dtype=torch.float32,
                                         device=dev))[:, None]
        mean = torch.as_tensor(self.positions, dtype=torch.float32,
                               device=dev)
        noise = torch.randn((batch_size,) + tuple(mean.shape),
                            generator=generator, device=dev)
        return mean + std * noise

    def draw_skeleton(self, ax=None, color="blue", alpha=1.0, linewidth=2.0):
        """Each edge as a line on a matplotlib axis (3-D axes get z); the
        axis is made here, on a new figure, when None."""
        if ax is None:
            import matplotlib.pyplot as plt
            ax = plt.figure().add_subplot(projection="3d")
        for p, i in self.edges:
            seg = np.stack([self.positions[p], self.positions[i]])
            if getattr(ax, "name", "") == "3d":
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color,
                        alpha=alpha, linewidth=linewidth)
            else:
                ax.plot(seg[:, 0], seg[:, 1], color=color, alpha=alpha,
                        linewidth=linewidth)
        return ax


def get_skeleton_from_model(model: KinematicModel, q,
                            link_list: Optional[Sequence[str]] = None
                            ) -> Skeleton:
    """The model's link frames at one configuration q (n_dofs,) (any
    array-like; FK runs on the model's device)."""
    q = torch.as_tensor(to_numpy(q), device=model.device).reshape(-1)
    _, t = fk_rot_trans(model, q)
    return Skeleton(link_names=list(model.link_names),
                    parent_idx=list(model.parent_idx),
                    positions=to_numpy(t))


def get_skeleton_from_landmarks(landmarks, connections,
                                present_thres: float = 0.5,
                                vis_thres: float = 0.5,
                                mirror: bool = False,
                                relative_pose: bool = False,
                                shift=np.zeros(3)) -> Optional[Skeleton]:
    """A Skeleton from pose-landmark detections: ``landmarks`` objects with
    ``x, y, z`` and optional ``visibility`` / ``presence``, ``connections``
    (start, end) index pairs.  The camera frame maps to the robot frame as
    (z, -x, -y), mirrored (-z, -x, y).  None when no landmark passes the
    thresholds."""
    if landmarks is None:
        return None
    plotted = {}
    for idx, lm in enumerate(landmarks):
        vis = getattr(lm, "visibility", None)
        pres = getattr(lm, "presence", None)
        if (vis is not None and vis < vis_thres) or \
           (pres is not None and pres < present_thres):
            continue
        if mirror:
            plotted[idx] = np.array([-lm.z, -lm.x, lm.y], np.float64)
        else:
            plotted[idx] = np.array([lm.z, -lm.x, -lm.y], np.float64)
    if not plotted:
        return None
    base = plotted[min(plotted)] if relative_pose else 0.0
    ids = sorted(plotted)
    id_to_row = {i: r for r, i in enumerate(ids)}
    positions = np.stack([plotted[i] - base + shift for i in ids])
    parent = [-1] * len(ids)
    for s, e in connections:
        if not (0 <= s < len(landmarks) and 0 <= e < len(landmarks)):
            raise ValueError(
                f"Landmark index out of range in connection ({s}, {e})")
        if s in plotted and e in plotted and parent[id_to_row[e]] < 0 \
                and id_to_row[s] != id_to_row[e]:
            parent[id_to_row[e]] = id_to_row[s]
    return Skeleton(link_names=[str(i) for i in ids], parent_idx=parent,
                    positions=positions,
                    variances=np.full((len(ids),), 1e-3))
