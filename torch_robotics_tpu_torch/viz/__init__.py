"""Host-side matplotlib rendering of scenes, robots and trajectories
(counterpart of torch_robotics_tpu/viz).  Every function takes the port's
tensors on any device and draws host numpy copies; matplotlib (and
mpl_toolkits for 3-D collections) is imported inside the functions that
draw, so the package imports where matplotlib is missing."""
from .planning_visualizer import PlanningVisualizer, create_fig_and_axes
from .plot_utils import plot_coordinate_frame
from .render_env import render_env, render_env_grad_sdf, render_env_sdf
from .render_robot import render_robot, render_robot_trajectories

__all__ = ["PlanningVisualizer", "create_fig_and_axes",
           "plot_coordinate_frame", "render_env", "render_env_grad_sdf",
           "render_env_sdf", "render_robot", "render_robot_trajectories"]
