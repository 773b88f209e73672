"""Compiled kinematic model: URDF -> static per-link arrays (counterpart of
torch_robotics_tpu/kin/model.py).

The model is built host-side in numpy (float32, like the reference's
arrays) and remembers the device its users run on.  FK code reads the
per-link constants as Python scalars (they are the same for every lane)
and the CUDA terms kernel packs them into one device buffer, so nothing
per-link is ever a per-call host-device copy.

Semantics follow the reference: joint local pose R = R_rpy(origin) @
R_axis(q), t = origin_xyz (+ axis * q for prismatic); revolute and
prismatic q are clamped to their limits inside FK, continuous joints are
not; link and q order follow the URDF file order; a revolute joint with a
zero axis rotates about z; non-axis-aligned axes use Rodrigues.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from .urdf import UrdfRobot

__all__ = ["KinematicModel", "JOINT_FIXED", "JOINT_REVOLUTE",
           "JOINT_CONTINUOUS", "JOINT_PRISMATIC"]

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_CONTINUOUS = 2
JOINT_PRISMATIC = 3

_JOINT_CODES = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_CONTINUOUS,
    "prismatic": JOINT_PRISMATIC,
}

_BIG = 1e9


def _np_rpy_to_rotation_matrix(rpy: np.ndarray) -> np.ndarray:
    """Host-side (float64) Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    R = np.empty(rpy.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


@dataclasses.dataclass(frozen=True)
class KinematicModel:
    """Static-array robot model; all per-link arrays in URDF file order."""
    joint_trans: np.ndarray         # (n_links, 3) float32
    joint_fixed_rot: np.ndarray     # (n_links, 3, 3)
    joint_axis: np.ndarray          # (n_links, 3)
    clamp_lower: np.ndarray         # (n_links,) -1e9 if not clamped
    clamp_upper: np.ndarray         # (n_links,) +1e9 if not clamped
    q_map: np.ndarray               # (n_links,) int32 index into q (0 if fixed)
    q_lower: np.ndarray             # (n_dofs,)
    q_upper: np.ndarray
    parent_idx: tuple               # -1 for the root
    joint_types: tuple              # per-link type codes
    device: torch.device
    name: str = "robot"
    link_names: tuple = ()

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_urdf_robot(cls, robot: UrdfRobot, name: str = "robot",
                        device="cuda") -> "KinematicModel":
        dev = resolve_device(device)
        joint_for_child = robot.joint_for_child()
        link_names = robot.link_names()
        name_to_idx = {n: i for i, n in enumerate(link_names)}
        n = len(link_names)

        trans = np.zeros((n, 3), np.float64)
        rpy = np.zeros((n, 3), np.float64)
        axis = np.zeros((n, 3), np.float64)
        clamp_lower = np.full(n, -_BIG, np.float64)
        clamp_upper = np.full(n, _BIG, np.float64)
        q_map = np.zeros(n, np.int32)
        parent_idx = [-1] * n
        joint_types = [JOINT_FIXED] * n
        q_lower, q_upper = [], []
        n_dofs = 0

        for i, lname in enumerate(link_names):
            j = joint_for_child.get(lname)
            if j is None:
                continue  # root: identity joint
            if j.type not in _JOINT_CODES:
                raise NotImplementedError(f"joint type {j.type} ({j.name})")
            code = _JOINT_CODES[j.type]
            parent_idx[i] = name_to_idx[j.parent]
            joint_types[i] = code
            trans[i] = j.origin_xyz
            rpy[i] = j.origin_rpy
            if code in (JOINT_REVOLUTE, JOINT_CONTINUOUS):
                a = np.asarray(j.axis, np.float64)
                if np.linalg.norm(a) == 0.0:
                    a = np.array([0.0, 0.0, 1.0])
                axis[i] = a
            elif code == JOINT_PRISMATIC:
                axis[i] = j.axis
            if code != JOINT_FIXED:
                q_map[i] = n_dofs
                lower, upper = j.limit_lower, j.limit_upper
                if code == JOINT_CONTINUOUS:
                    lower, upper = -np.pi, np.pi
                elif j.has_limit:
                    clamp_lower[i] = lower
                    clamp_upper[i] = upper
                q_lower.append(lower)
                q_upper.append(upper)
                n_dofs += 1

        for i, p in enumerate(parent_idx):
            if p == i:
                raise ValueError(f"link {link_names[i]} is its own parent")

        f32 = np.float32
        return cls(
            joint_trans=trans.astype(f32),
            joint_fixed_rot=_np_rpy_to_rotation_matrix(rpy).astype(f32),
            joint_axis=axis.astype(f32),
            clamp_lower=clamp_lower.astype(f32),
            clamp_upper=clamp_upper.astype(f32),
            q_map=q_map,
            q_lower=np.asarray(q_lower, np.float64).astype(f32),
            q_upper=np.asarray(q_upper, np.float64).astype(f32),
            parent_idx=tuple(parent_idx),
            joint_types=tuple(joint_types),
            device=dev,
            name=name,
            link_names=tuple(link_names),
        )

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @functools.cached_property
    def tensors(self) -> dict:
        """Device copies of the per-link float arrays, made once."""
        return {k: torch.tensor(getattr(self, k), device=self.device)
                for k in ("joint_trans", "joint_fixed_rot", "joint_axis")}

    @property
    def n_links(self) -> int:
        return len(self.parent_idx)

    @property
    def n_dofs(self) -> int:
        return len(self.controlled_link_idxs())

    def link_index(self, link_name: str) -> int:
        return self.link_names.index(link_name)

    def topological_order(self) -> Sequence[int]:
        """Indices ordered so parents precede children (root first)."""
        order, seen = [], set()

        def visit(i):
            if i in seen:
                return
            p = self.parent_idx[i]
            if p >= 0:
                visit(p)
            seen.add(i)
            order.append(i)

        for i in range(self.n_links):
            visit(i)
        return order

    def controlled_link_idxs(self) -> Sequence[int]:
        """Link indices whose joints are movable, in q order (URDF file
        order is q order)."""
        return tuple(i for i, t in enumerate(self.joint_types)
                     if t != JOINT_FIXED)

    def ancestry_matrix(self) -> np.ndarray:
        """(n_links, n_dofs) bool: joint j moves link i."""
        ctrl = self.controlled_link_idxs()
        joint_of_link = {li: d for d, li in enumerate(ctrl)}
        A = np.zeros((self.n_links, len(ctrl)), bool)
        for i in range(self.n_links):
            p = i
            while p >= 0:
                if p in joint_of_link:
                    A[i, joint_of_link[p]] = True
                p = self.parent_idx[p]
        return A
