"""MotionPlanningController: execute planned trajectories and score them
(counterpart of torch_robotics_tpu/sim/motion_planning_controller.py).

Runs B planned trajectories of a task through the PD execution harness
and reports the executed states and how many ran without contact."""
from __future__ import annotations

from typing import Optional

import torch

from .rollout import ExecutionResult, PDControllerParams, execute_trajectories

__all__ = ["MotionPlanningController"]


class MotionPlanningController:
    def __init__(self, task, params: Optional[PDControllerParams] = None):
        self.task = task
        self.params = params or PDControllerParams()

    def _collision_fn(self, q):
        return self.task._compute_collision(q, margin_override=None)

    def run_trajectories(self, trajs, start_states_join=None,
                         goal_states_join=None):
        """trajs: (B, H, d_state) planned trajectories (positions only
        take finite-difference velocities, the robot's ``get_velocity``).
        Returns (ExecutionResult, n_contact_free); the start and goal
        arguments are the reference's and unused."""
        trajs = torch.as_tensor(trajs)
        robot = self.task.robot
        result: ExecutionResult = execute_trajectories(
            self._collision_fn, robot.get_position(trajs),
            robot.get_velocity(trajs), self.params)
        return result, int((~result.frozen).sum())
