"""PlanningTask: robot + environment -> Gauss-Newton collision terms
(counterpart of torch_robotics_tpu/tasks/planning_task.py, as far as the
main path needs it: ``collision_residuals.obstacle_terms_lanes``).

The task composes the collision rows (objects, workspace bounds,
self-collision pairs) of the robot in the scene.  Its lanes terms come
from the CUDA terms kernel's wrapper, which takes the kernel for CUDA
tensors and the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import disable_tf32

__all__ = ["PlanningTask", "CollisionResiduals"]


class CollisionResiduals:
    """Per-waypoint hinge collision residuals of a task.  This slice carries
    the fully lane-vectorized GN terms ``obstacle_terms_lanes(q_cols (d, N),
    lam, h=None) -> (g, Hb, cost)``; residual values and Jacobians alone
    wait for a later slice."""

    def __init__(self, obstacle_terms_lanes):
        self.obstacle_terms_lanes = obstacle_terms_lanes


class PlanningTask:
    def __init__(self, env=None, robot=None, ws_limits=None,
                 obstacle_cutoff_margin: float = 0.01):
        # GN systems NaN under TF32 products (core/device.py)
        disable_tf32()
        self.env = env
        self.robot = robot
        self.device = robot.device
        limits = env.limits if ws_limits is None else torch.as_tensor(
            np.asarray(ws_limits, np.float64), dtype=torch.float32,
            device=self.device)
        self.ws_limits = limits
        self.ws_min = limits[0]
        self.ws_max = limits[1]
        self.obstacle_cutoff_margin = obstacle_cutoff_margin
        self.df_obj_list = env.get_df_obj_list()
        self.collision_residuals = self._build_residuals()

    def _build_residuals(self) -> CollisionResiduals:
        from ..ops.terms_kernel import obstacle_terms_kernel_factory
        return CollisionResiduals(obstacle_terms_kernel_factory(self))
