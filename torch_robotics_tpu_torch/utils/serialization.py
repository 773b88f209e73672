"""Serialization of precomputed artifacts: SDF grids and kinematic models
(counterpart of torch_robotics_tpu/utils/serialization.py).

Each is one ``.npz`` archive with the reference's keys and layouts (a
model's structure as UTF-8 JSON in a ``__meta__`` byte array), so that a
file saved by either package loads in the other.  Loading takes the device
the loaded tensors live on.
"""
from __future__ import annotations

import json

import numpy as np

from ..core.device import resolve_device
from ..geom.grid_sdf import GridSDF
from ..kin.model import (JOINT_CONTINUOUS, JOINT_PRISMATIC, JOINT_REVOLUTE,
                         KinematicModel)

__all__ = ["save_grid_sdf", "load_grid_sdf", "save_kinematic_model",
           "load_kinematic_model"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_grid_sdf(path, grid: GridSDF) -> None:
    """Write the grid's limits, SDF and gradient grids and cell counts."""
    np.savez_compressed(
        path,
        limits=_np(grid.limits),
        sdf_grid=_np(grid.sdf_grid),
        grad_grid=_np(grid.grad_grid),
        cmap_dim=np.asarray(grid.cmap_dim, np.int64),
    )


def load_grid_sdf(path, device="cuda") -> GridSDF:
    """The grid saved at ``path``, as float32 tensors on ``device``."""
    data = np.load(path)
    return GridSDF.create(data["limits"], data["sdf_grid"], data["grad_grid"],
                          cmap_dim=tuple(int(v) for v in data["cmap_dim"]),
                          device=device)


# the reference model's array fields, in its order; rot_mask / prism_mask
# are its per-link joint-kind masks, which the port derives from joint_types
_MODEL_ARRAY_FIELDS = [
    "joint_trans", "joint_fixed_rot", "joint_axis", "rot_mask", "prism_mask",
    "clamp_lower", "clamp_upper", "q_map", "q_lower", "q_upper", "q_velocity",
    "q_effort", "joint_damping",
]
_PER_DOF = ("q_velocity", "q_effort", "joint_damping")


def save_kinematic_model(path, model: KinematicModel) -> None:
    """Write the model's arrays and its structure (name, link and joint
    names, parents, joint types, dofs).  A model built without the URDF's
    velocity and effort limits or damping writes zeros for them, and
    "base_joint" for joint names it lacks."""
    types = np.asarray(model.joint_types)
    arrays = {
        "rot_mask": np.isin(types, (JOINT_REVOLUTE, JOINT_CONTINUOUS)
                            ).astype(np.float32),
        "prism_mask": (types == JOINT_PRISMATIC).astype(np.float32),
    }
    for f in _MODEL_ARRAY_FIELDS:
        if f in arrays:
            continue
        a = getattr(model, f)
        arrays[f] = (np.zeros(model.n_dofs, np.float32)
                     if a is None and f in _PER_DOF else np.asarray(a))
    meta = {
        "name": model.name,
        "link_names": list(model.link_names),
        "joint_names": list(model.joint_names
                            or ("base_joint",) * model.n_links),
        "parent_idx": list(model.parent_idx),
        "joint_types": list(model.joint_types),
        "n_dofs": model.n_dofs,
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_kinematic_model(path, device="cuda") -> KinematicModel:
    """The model saved at ``path``, its users' device ``device``."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    f32 = {f: np.asarray(data[f], np.float32) for f in _MODEL_ARRAY_FIELDS
           if f not in ("rot_mask", "prism_mask", "q_map")}
    model = KinematicModel(
        **f32,
        q_map=np.asarray(data["q_map"], np.int32),
        parent_idx=tuple(int(p) for p in meta["parent_idx"]),
        joint_types=tuple(int(t) for t in meta["joint_types"]),
        device=resolve_device(device),
        name=meta["name"],
        link_names=tuple(meta["link_names"]),
        joint_names=tuple(meta["joint_names"]),
    )
    if model.n_dofs != int(meta["n_dofs"]):
        raise ValueError("%s: %d movable joints but n_dofs %d"
                         % (path, model.n_dofs, int(meta["n_dofs"])))
    return model
