"""Execution harness (counterpart of torch_robotics_tpu/sim): PD-tracked
rollout of planned trajectories with a contact check each step, the
controller that runs a task's plans through it and scores them, and the
MuJoCo adapter that executes plans under MuJoCo's contact dynamics
(``mujoco`` imported only when an adapter is built)."""
from .motion_planning_controller import MotionPlanningController
from .mujoco_adapter import (MujocoExecutionEnv, MujocoExecutionResult,
                             build_mj_spec)
from .rollout import ExecutionResult, PDControllerParams, execute_trajectories

__all__ = ["PDControllerParams", "ExecutionResult", "execute_trajectories",
           "MotionPlanningController", "MujocoExecutionEnv",
           "MujocoExecutionResult", "build_mj_spec"]
