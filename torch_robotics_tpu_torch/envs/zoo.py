"""Environment zoo built from the layout data asset (counterpart of
torch_robotics_tpu/envs/zoo.py).

Layouts (primitive coordinates, workspace limits) are data:
``env_layouts.json`` in the JAX package's data directory, read in place.
"""
from __future__ import annotations

import json
from functools import lru_cache

from ..geom.sdf import (MultiBoxField, MultiSharpBoxField, MultiSphereField,
                        ObjectField)
from ..utils.files import get_data_path
from .base import EnvBase

__all__ = ["make_env", "EnvSpheres3D", "EnvMazeBoxes3D", "EnvDense2D"]


@lru_cache(maxsize=1)
def _layouts() -> dict:
    return json.loads((get_data_path() / "env_layouts.json").read_text())


def _build_field(spec: dict, device):
    if spec["type"] == "spheres":
        return MultiSphereField(spec["centers"], spec["radii"], device=device)
    if spec["type"] == "rounded_boxes":
        return MultiBoxField(spec["centers"], spec["sizes"], device=device)
    if spec["type"] == "sharp_boxes":
        return MultiSharpBoxField(spec["centers"], spec["sizes"],
                                  device=device)
    raise NotImplementedError(spec["type"])


def _build_object(spec: dict, device):
    fields = [_build_field(f, device) for f in spec["fields"]]
    return ObjectField.create(fields, name=spec["name"], pos=spec["pos"],
                              ori=spec["ori"], device=device)


def make_env(name: str, precompute_sdf_obj_fixed: bool = False,
             device="cuda") -> EnvBase:
    spec = _layouts()[name]
    return EnvBase(
        name=name,
        limits=spec["limits"],
        obj_fixed_list=[_build_object(o, device) for o in spec["obj_fixed"]],
        obj_extra_list=([_build_object(o, device) for o in spec["obj_extra"]]
                        if spec["obj_extra"] else None),
        precompute_sdf_obj_fixed=precompute_sdf_obj_fixed,
        device=device,
        planner_params=spec["planner_params"],
    )


def EnvSpheres3D(precompute_sdf_obj_fixed: bool = False,
                 device="cuda") -> EnvBase:
    """The main path's scene: ten spheres in a [-1, 1]^3 workspace."""
    return make_env("EnvSpheres3D", precompute_sdf_obj_fixed, device)


def EnvMazeBoxes3D(precompute_sdf_obj_fixed: bool = False,
                   device="cuda") -> EnvBase:
    """Fourteen rounded boxes in a [-1, 1]^3 workspace."""
    return make_env("EnvMazeBoxes3D", precompute_sdf_obj_fixed, device)


def EnvDense2D(precompute_sdf_obj_fixed: bool = False,
               device="cuda") -> EnvBase:
    """Config 2's scene: sixteen circles and fourteen rounded boxes in a
    [-1, 1]^2 workspace."""
    return make_env("EnvDense2D", precompute_sdf_obj_fixed, device)
