"""Environment base: workspace limits + obstacle objects + planner presets
(counterpart of torch_robotics_tpu/envs/base.py without the precomputed SDF
grid and the occupancy map, which are not ported yet)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..geom.sdf import ObjectField

__all__ = ["EnvBase"]


class EnvBase:
    def __init__(self, name: str = "EnvBase", limits=None,
                 obj_fixed_list: Optional[Sequence[ObjectField]] = None,
                 obj_extra_list: Optional[Sequence[ObjectField]] = None,
                 precompute_sdf_obj_fixed: bool = False, device="cuda",
                 planner_params: Optional[dict] = None):
        if limits is None:
            raise ValueError("EnvBase needs workspace limits")
        if precompute_sdf_obj_fixed:
            raise NotImplementedError(
                "precomputed SDF grids are not ported yet")
        self.device = resolve_device(device)
        self.name = name
        self.limits = torch.as_tensor(np.asarray(limits, np.float64),
                                      dtype=torch.float32,
                                      device=self.device)
        self.dim = self.limits.shape[-1]
        self.obj_fixed_list = list(obj_fixed_list or [])
        self.obj_extra_list = (list(obj_extra_list)
                               if obj_extra_list is not None else None)
        self.obj_all_list = self.obj_fixed_list + (self.obj_extra_list or [])
        self._planner_params = planner_params or {}

    def get_df_obj_list(self, return_extra_objects_only: bool = False):
        """Distance-field objects for cost evaluation."""
        df_obj_l = [] if return_extra_objects_only else list(
            self.obj_fixed_list)
        if self.obj_extra_list is not None:
            df_obj_l.extend(self.obj_extra_list)
        return df_obj_l

    def compute_sdf(self, x):
        """Min-over-objects SDF at world points x (..., dim)."""
        sdf = None
        for obj in self.obj_all_list:
            s = obj.signed_distance(x)
            sdf = s if sdf is None else torch.minimum(sdf, s)
        return sdf

    def _get_params(self, method: str, robot=None) -> dict:
        """The scene's preset for ``method``; raises when there is none or
        when it is for another robot."""
        entry = self._planner_params.get(method)
        if entry is None:
            raise NotImplementedError(f"{self.name} has no {method} preset")
        expected = entry.get("robot")
        if robot is not None and expected is not None:
            robot_name = getattr(robot, "name", type(robot).__name__)
            if expected not in (robot_name, type(robot).__name__):
                raise NotImplementedError(
                    f"{self.name} {method} preset is for {expected}, "
                    f"got {robot_name}")
        return dict(entry["params"])

    def get_gpmp2_params(self, robot=None) -> dict:
        """GPMP2 hyperparameters (``solve.GPMP2Params.from_preset``)."""
        return self._get_params("gpmp2", robot)

    def get_sgpmp_params(self, robot=None) -> dict:
        """sGPMP hyperparameters (``solve.SGPMPParams.from_preset``)."""
        return self._get_params("sgpmp", robot)
