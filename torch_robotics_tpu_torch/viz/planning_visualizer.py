"""Planning visualizer: the scene with collision-coloured trajectories,
animations of optimization iterations, planned and executed motion to
video, and joint-space plots (counterpart of
torch_robotics_tpu/viz/planning_visualizer.py).  Trajectories are the
port's tensors on any device; the drawing is host-side matplotlib."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core.utils import to_numpy
from .render_env import create_fig_and_axes, render_env
from .render_robot import render_robot, render_robot_trajectories

__all__ = ["PlanningVisualizer", "create_fig_and_axes"]


class PlanningVisualizer:
    def __init__(self, task=None, planner=None):
        self.task = task
        self.env = task.env
        self.robot = task.robot
        self.planner = planner

    def render_robot_trajectories(self, fig=None, ax=None, trajs=None,
                                  start_state=None, goal_state=None,
                                  render_planner=False, **kwargs):
        if fig is None or ax is None:
            fig, ax = create_fig_and_axes(self.env.dim)
        render_env(self.env, ax)
        if trajs is not None:
            # colliding trajectories black, free ones orange (the
            # reference's colours)
            coll_mask, _ = self.task.trajs_collision_masks(trajs)
            colors = ["black" if bool(c) else "orange"
                      for c in to_numpy(coll_mask, bool).reshape(-1)]
            render_robot_trajectories(
                self.robot, ax, trajs, start_state=start_state,
                goal_state=goal_state, colors=colors, **kwargs)
        return fig, ax

    def animate_robot_trajectories(self, trajs=None, start_state=None,
                                   goal_state=None,
                                   n_frames: Optional[int] = None,
                                   video_filepath="robot_trajs.mp4",
                                   anim_time=5.0, **kwargs):
        """Animate waypoint-by-waypoint execution to a video file."""
        if trajs is None:
            return
        H = trajs.shape[-2]
        n_frames = n_frames or H

        def draw_frame(ax, t):
            render_env(self.env, ax)
            render_robot_trajectories(self.robot, ax, trajs[..., :t + 1, :],
                                      start_state=start_state,
                                      goal_state=goal_state, **kwargs)

        return self._animate(draw_frame, n_frames, video_filepath, anim_time)

    def animate_opt_iters_robots(self, trajs=None, start_state=None,
                                 goal_state=None,
                                 video_filepath="opt_iters.mp4",
                                 n_frames: Optional[int] = None,
                                 anim_time=5.0, **kwargs):
        """trajs: (n_iters, B, H, D) optimization snapshots."""
        if trajs is None:
            return
        n_iters = trajs.shape[0]
        n_frames = min(n_frames or n_iters, n_iters)
        idxs = np.linspace(0, n_iters - 1, n_frames).astype(int)

        def draw_frame(ax, i):
            render_env(self.env, ax)
            render_robot_trajectories(self.robot, ax, trajs[idxs[i]],
                                      start_state=start_state,
                                      goal_state=goal_state, **kwargs)
            ax.set_title(f"iter {idxs[i]}")

        return self._animate(draw_frame, n_frames, video_filepath, anim_time)

    def animate_execution(self, qpos_executed, contact=None,
                          contact_step=None, video_filepath="execution.mp4",
                          anim_time=5.0, draw_links_spheres=True,
                          max_robots: int = 8, **kwargs):
        """Record executed (physics-integrated) trajectories to mp4 / gif:
        ``MujocoExecutionResult.qpos_executed`` (B, H, d) with its
        ``contact`` / ``contact_step``.  Each robot is drawn at each
        executed step with its collision spheres and end-effector frame
        (kinematic-tree robots); a robot whose rollout reported contact
        turns red from its contact step on.  The renderer is matplotlib's,
        offscreen."""
        qpos = np.atleast_3d(to_numpy(qpos_executed))[:max_robots]
        B, H, _ = qpos.shape
        contact = (np.zeros(B, bool) if contact is None
                   else np.asarray(contact)[:max_robots])
        contact_step = (np.full(B, -1) if contact_step is None
                        else np.asarray(contact_step)[:max_robots])

        def draw_frame(ax, t):
            render_env(self.env, ax)
            n_con = 0
            for b in range(B):
                hit = contact[b] and 0 <= contact_step[b] <= t
                n_con += bool(hit)
                render_robot(self.robot, ax, qpos[b, t],
                             color="red" if hit else "blue",
                             draw_links_spheres=draw_links_spheres, **kwargs)
            ax.set_title(f"step {t}/{H - 1}   contacts {n_con}/{B}")

        return self._animate(draw_frame, H, video_filepath, anim_time)

    def _animate(self, draw_frame, n_frames, video_filepath, anim_time):
        """Save the frames to ``video_filepath`` (mp4 through ffmpeg where
        matplotlib finds it, else a gif through pillow, the path's suffix
        changed to .gif) -> the path written."""
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
        fig, ax = create_fig_and_axes(self.env.dim)

        def update(t):
            ax.clear()
            draw_frame(ax, t)

        anim = animation.FuncAnimation(
            fig, update, frames=n_frames,
            interval=anim_time * 1000.0 / max(n_frames, 1))
        ext = os.path.splitext(video_filepath)[1].lower()
        writer = ("pillow" if ext == ".gif" else
                  animation.FFMpegWriter(fps=max(int(n_frames / anim_time), 1))
                  if animation.writers.is_available("ffmpeg") else "pillow")
        if writer == "pillow" and ext != ".gif":
            video_filepath = os.path.splitext(video_filepath)[0] + ".gif"
        anim.save(video_filepath, writer=writer)
        plt.close(fig)
        return video_filepath

    def plot_joint_space_state_trajectories(self, trajs=None,
                                            pos_start_state=None,
                                            pos_goal_state=None,
                                            vel_start_state=None,
                                            vel_goal_state=None, **kwargs):
        """Per-joint position / velocity curves over the horizon."""
        import matplotlib.pyplot as plt
        if trajs is None:
            return None, None
        q = to_numpy(self.robot.get_position(trajs))
        qd = to_numpy(self.robot.get_velocity(trajs))
        d = q.shape[-1]
        fig, axs = plt.subplots(d, 2, squeeze=False, figsize=(10, 2 * d))
        for j in range(d):
            for traj_q, traj_qd in zip(q, qd):
                axs[j][0].plot(traj_q[:, j], alpha=0.6)
                axs[j][1].plot(traj_qd[:, j], alpha=0.6)
            axs[j][0].set_ylabel(f"q{j}")
            axs[j][1].set_ylabel(f"qd{j}")
            if pos_start_state is not None:
                axs[j][0].scatter(0, to_numpy(pos_start_state)[j], c="green")
            if pos_goal_state is not None:
                axs[j][0].scatter(q.shape[-2] - 1,
                                  to_numpy(pos_goal_state)[j], c="purple")
        return fig, axs
