"""Execution harness (counterpart of torch_robotics_tpu/sim): PD-tracked
rollout of planned trajectories with a contact check each step, and the
controller that runs a task's plans through it and scores them.  The JAX
package's MuJoCo adapter is not ported."""
from .motion_planning_controller import MotionPlanningController
from .rollout import ExecutionResult, PDControllerParams, execute_trajectories

__all__ = ["PDControllerParams", "ExecutionResult", "execute_trajectories",
           "MotionPlanningController"]
