"""Environment base: workspace limits, obstacle objects, an optional
precomputed SDF grid of the fixed objects, an occupancy map builder,
planner presets and rendering (counterpart of
torch_robotics_tpu/envs/base.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..geom.grid_sdf import precompute_sdf_grid
from ..geom.occupancy import build_occupancy_map
from ..geom.sdf import ObjectField

__all__ = ["EnvBase"]


class EnvBase:
    def __init__(self, name: str = "EnvBase", limits=None,
                 obj_fixed_list: Optional[Sequence[ObjectField]] = None,
                 obj_extra_list: Optional[Sequence[ObjectField]] = None,
                 precompute_sdf_obj_fixed: bool = False,
                 sdf_cell_size: float = 0.005, device="cuda",
                 planner_params: Optional[dict] = None):
        if limits is None:
            raise ValueError("EnvBase needs workspace limits")
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
        self.sdf_cell_size = sdf_cell_size
        self.grid_map_sdf_obj_fixed = (
            precompute_sdf_grid(self.limits, sdf_cell_size,
                                self.obj_fixed_list, device=self.device)
            if precompute_sdf_obj_fixed else None)
        self.occupancy_map = None
        self.cell_size = None

    def get_obj_list(self):
        return self.obj_all_list

    def get_df_obj_list(self, return_extra_objects_only: bool = False):
        """Distance-field objects for cost evaluation: the fixed objects,
        replaced by their precomputed grid when there is one, then the
        extra objects."""
        df_obj_l = []
        if not return_extra_objects_only:
            if self.grid_map_sdf_obj_fixed is not None:
                df_obj_l.append(self.grid_map_sdf_obj_fixed)
            else:
                df_obj_l.extend(self.obj_fixed_list)
        if self.obj_extra_list is not None:
            df_obj_l.extend(self.obj_extra_list)
        return df_obj_l

    def build_occupancy_map(self, cell_size: float = 0.01):
        """Rasterize every object into ``self.occupancy_map``."""
        self.cell_size = cell_size
        self.occupancy_map = build_occupancy_map(
            self.limits, cell_size, self.obj_all_list, device=self.device)
        return self.occupancy_map

    def compute_sdf(self, x):
        """Min-over-objects SDF at world points x (..., dim): the grid in
        place of the fixed objects when there is one."""
        sdf = None
        for obj in self.get_df_obj_list():
            s = obj.signed_distance(x)
            sdf = s if sdf is None else torch.minimum(sdf, s)
        return sdf

    def _preset_refusal(self, method: str, robot=None):
        """Why the scene has no ``method`` preset for ``robot`` (None when it
        has one)."""
        entry = self._planner_params.get(method)
        if entry is None:
            return f"{self.name} has no {method} preset"
        expected = entry.get("robot")
        if robot is not None and expected is not None:
            robot_name = getattr(robot, "name", type(robot).__name__)
            if expected not in (robot_name, type(robot).__name__):
                return (f"{self.name} {method} preset is for {expected}, "
                        f"got {robot_name}")
        return None

    def has_preset(self, method: str, robot=None) -> bool:
        """Whether ``get_<method>_params(robot)`` returns a preset."""
        return self._preset_refusal(method, robot) is None

    def _get_params(self, method: str, robot=None) -> dict:
        """The scene's preset for ``method``; raises when there is none or
        when it is for another robot."""
        refusal = self._preset_refusal(method, robot)
        if refusal is not None:
            raise NotImplementedError(refusal)
        return dict(self._planner_params[method]["params"])

    def get_rrt_connect_params(self, robot=None) -> dict:
        """RRT-Connect hyperparameters (``solve.RRTConnectParams.
        from_preset``)."""
        return self._get_params("rrt_connect", robot)

    def get_gpmp2_params(self, robot=None) -> dict:
        """GPMP2 hyperparameters (``solve.GPMP2Params.from_preset``)."""
        return self._get_params("gpmp2", robot)

    def get_chomp_params(self, robot=None) -> dict:
        """CHOMP hyperparameters (``solve.CHOMPParams.from_preset``)."""
        return self._get_params("chomp", robot)

    def get_sgpmp_params(self, robot=None) -> dict:
        """sGPMP hyperparameters (``solve.SGPMPParams.from_preset``)."""
        return self._get_params("sgpmp", robot)

    def get_mpot_params(self, robot=None) -> dict:
        """MPOT hyperparameters (``solve.MPOTParams.from_preset``)."""
        return self._get_params("mpot", robot)

    # rendering (host-side matplotlib, viz/render_env.py)
    def render(self, ax=None):
        from ..viz.render_env import render_env
        render_env(self, ax)

    def render_sdf(self, ax=None, fig=None):
        from ..viz.render_env import render_env_sdf
        render_env_sdf(self, ax, fig)

    def render_grad_sdf(self, ax=None, fig=None):
        from ..viz.render_env import render_env_grad_sdf
        render_env_grad_sdf(self, ax, fig)
