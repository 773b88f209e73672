"""Environment zoo built from the layout data asset (counterpart of
torch_robotics_tpu/envs/zoo.py).

Layouts (primitive coordinates, workspace limits, the reference's planner
presets) are data: ``env_layouts.json`` in the JAX package's data
directory, read in place.  The presets tuned beyond the reference's
(``_TUNED_PLANNER_PARAMS``) are merged over them, as the JAX package
merges its own.
"""
from __future__ import annotations

import json
from functools import lru_cache

from ..geom.sdf import (MultiBoxField, MultiSharpBoxField, MultiSphereField,
                        ObjectField)
from ..utils.files import get_data_path
from .base import EnvBase

__all__ = [
    "make_env", "available_envs",
    "EnvSimple2D", "EnvSimple2DExtraObjects", "EnvCircle2D", "EnvDense2D",
    "EnvDense2DExtraObjects", "EnvGridCircles2D", "EnvMazeBoxes3D",
    "EnvNarrowPassageDense2D", "EnvNarrowPassageDense2DExtraObjects",
    "EnvPlanar2Link", "EnvSpheres3D", "EnvSpheres3DExtraObjects",
    "EnvSquare2D", "EnvTableShelf",
]


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


def available_envs():
    return sorted(_layouts().keys())


# Planner presets tuned beyond what the reference ships (the JAX package's
# envs/zoo.py _TUNED_PLANNER_PARAMS).  EnvDense2D's MPOT: the reference has
# a preset only for the regular GridCircles2D scene; dense random clutter
# wants bigger Sinkhorn steps, deeper probes and more OT iterations
# (benchmarks/mpot_dense2d_sweep.py; the other MPOTParams fields keep their
# GridCircles2D-derived defaults).
_TUNED_PLANNER_PARAMS = {
    "EnvDense2D": {
        "mpot": {
            "robot": "RobotPointMass",
            "params": {"opt_iters": 300, "step_radius": 0.07,
                       "probe_radius": 0.09, "num_probe": 9},
        },
    },
}


def make_env(name: str, precompute_sdf_obj_fixed: bool = False,
             sdf_cell_size: float = 0.005, device="cuda") -> EnvBase:
    spec = _layouts()[name]
    return EnvBase(
        name=name,
        limits=spec["limits"],
        obj_fixed_list=[_build_object(o, device) for o in spec["obj_fixed"]],
        obj_extra_list=([_build_object(o, device) for o in spec["obj_extra"]]
                        if spec["obj_extra"] else None),
        precompute_sdf_obj_fixed=precompute_sdf_obj_fixed,
        sdf_cell_size=sdf_cell_size, device=device,
        planner_params={**spec["planner_params"],
                        **_TUNED_PLANNER_PARAMS.get(name, {})},
    )


def _make_ctor(env_name: str, doc: str):
    def ctor(precompute_sdf_obj_fixed: bool = False,
             sdf_cell_size: float = 0.005, device="cuda") -> EnvBase:
        return make_env(env_name, precompute_sdf_obj_fixed, sdf_cell_size,
                        device)
    ctor.__name__ = ctor.__qualname__ = env_name
    ctor.__doc__ = doc
    return ctor


EnvSimple2D = _make_ctor("EnvSimple2D", "Fifteen circles in [-1, 1]^2.")
EnvSimple2DExtraObjects = _make_ctor(
    "EnvSimple2DExtraObjects", "EnvSimple2D with extra (movable) objects.")
EnvCircle2D = _make_ctor("EnvCircle2D", "One circle in [-1, 1]^2.")
EnvDense2D = _make_ctor(
    "EnvDense2D", "Config 2's scene: sixteen circles and fourteen rounded "
    "boxes in a [-1, 1]^2 workspace.")
EnvDense2DExtraObjects = _make_ctor(
    "EnvDense2DExtraObjects", "EnvDense2D with extra (movable) objects.")
EnvGridCircles2D = _make_ctor(
    "EnvGridCircles2D", "A 7 x 7 grid of circles in [-1, 1]^2 (the scene of "
    "the reference's MPOT preset).")
EnvMazeBoxes3D = _make_ctor(
    "EnvMazeBoxes3D", "Fourteen rounded boxes in a [-1, 1]^3 workspace.")
EnvNarrowPassageDense2D = _make_ctor(
    "EnvNarrowPassageDense2D", "Eight circles and eleven rounded boxes "
    "around a narrow passage in a [-1, 1]^2 workspace (the hybrid planner's "
    "test scene).")
EnvNarrowPassageDense2DExtraObjects = _make_ctor(
    "EnvNarrowPassageDense2DExtraObjects",
    "EnvNarrowPassageDense2D with extra (movable) objects.")
EnvPlanar2Link = _make_ctor(
    "EnvPlanar2Link", "Six circles around the planar 2-link arm's base in "
    "[-1, 1]^2 (no planner presets).")
EnvSpheres3D = _make_ctor(
    "EnvSpheres3D", "The main path's scene: ten spheres in a [-1, 1]^3 "
    "workspace.")
EnvSpheres3DExtraObjects = _make_ctor(
    "EnvSpheres3DExtraObjects", "EnvSpheres3D with extra (movable) objects.")
EnvSquare2D = _make_ctor("EnvSquare2D", "One rounded box in [-1, 1]^2.")
EnvTableShelf = _make_ctor(
    "EnvTableShelf", "A table and a ten-box shelf for the Panda.")
