"""Robot rendering (host-side matplotlib), dispatched on the robot's type
(counterpart of torch_robotics_tpu/viz/render_robot.py): the point mass as
discs or spheres of its margin, the planar 2-link arm as its two links,
the Panda as the skeleton of its compiled model (each link to its parent)
with its end-effector frame and, optionally, its collision spheres."""
from __future__ import annotations

import numpy as np
import torch

from ..core.utils import to_numpy
from .plot_utils import plot_coordinate_frame
from .render_primitives import plot_sphere


def render_robot(robot, ax, q=None, color="blue", cmap="Blues", **kwargs):
    from ..robots import RobotPanda, RobotPlanar2Link, RobotPointMass
    if isinstance(robot, RobotPointMass):
        return _render_point_mass(robot, ax, q, color=color, cmap=cmap,
                                  **kwargs)
    if isinstance(robot, RobotPlanar2Link):
        return _render_planar2link(robot, ax, q, color=color, **kwargs)
    if isinstance(robot, RobotPanda):
        return _render_kinematic_tree(robot, ax, q, color=color, **kwargs)
    raise NotImplementedError(type(robot))


def _render_point_mass(robot, ax, q, color="blue", cmap="Blues",
                       margin_multiplier=1.0, **kwargs):
    import matplotlib.pyplot as plt
    if q is None:
        return
    margin = float(robot.object_margins[0]) * margin_multiplier
    for q_ in np.atleast_2d(to_numpy(q)):
        if robot.q_dim == 2:
            ax.add_patch(plt.Circle(q_, margin, color=color, zorder=10))
        else:
            plot_sphere(ax, q_, np.zeros_like(q_), margin, cmap)


def _render_planar2link(robot, ax, q, color="blue", alpha=1.0,
                        linewidth=2.0, **kwargs):
    q = torch.as_tensor(to_numpy(q)).reshape(2).to(robot.q_min.device)
    p0, p1, p2 = (to_numpy(p).reshape(-1) for p in robot.link_positions(q))
    ax.plot([p0[0], p1[0]], [p0[1], p1[1]], color=color,
            linewidth=linewidth, alpha=alpha)
    ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color=color,
            linewidth=linewidth, alpha=alpha)
    ax.scatter(p2[0], p2[1], color="red", marker="o")


def _render_kinematic_tree(robot, ax, q, color="blue", arrow_length=0.15,
                           arrow_alpha=1.0, arrow_linewidth=2.0,
                           draw_links_spheres=False, **kwargs):
    from ..kin import fk_rot_trans
    model = robot.model
    q = torch.as_tensor(to_numpy(q)).reshape(-1).to(robot.q_min.device)
    R, t = fk_rot_trans(model, q)
    t_np = to_numpy(t)
    for i, p in enumerate(model.parent_idx):     # each link to its parent
        if p < 0:
            continue
        seg = np.stack([t_np[p], t_np[i]])
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color)
    if draw_links_spheres:
        pts = to_numpy(robot.object_collision_points(t[None]))[0]
        margins = to_numpy(robot.object_margins)
        for c, r in zip(pts, margins):
            plot_sphere(ax, c, np.zeros(3), float(r), "Reds")
    ee = model.link_index(robot.link_name_ee)
    plot_coordinate_frame(ax, to_numpy(R)[ee], t_np[ee],
                          arrow_length=arrow_length, arrow_alpha=arrow_alpha,
                          arrow_linewidth=arrow_linewidth)


def render_robot_trajectories(robot, ax, trajs, start_state=None,
                              goal_state=None, colors=None, **kwargs):
    from ..robots import RobotPointMass
    trajs_np = to_numpy(robot.get_position(torch.as_tensor(trajs)))
    if colors is None:
        colors = ["gray"] * len(trajs_np)
    if isinstance(robot, RobotPointMass):
        _render_point_mass_trajs(robot, ax, trajs_np, colors, **kwargs)
    else:
        for traj, color in zip(trajs_np, colors):
            for q in traj:
                render_robot(robot, ax, q, color=color, arrow_length=0.1,
                             arrow_alpha=0.5, arrow_linewidth=1.0, **kwargs)
    if start_state is not None:
        render_robot(robot, ax, to_numpy(start_state)[..., :robot.q_dim],
                     color="green")
    if goal_state is not None:
        render_robot(robot, ax, to_numpy(goal_state)[..., :robot.q_dim],
                     color="purple")


def _render_point_mass_trajs(robot, ax, trajs_np, colors, linestyle="solid",
                             **kwargs):
    import matplotlib.collections as mcoll
    segments = [t for t in trajs_np]
    if robot.q_dim == 3:
        from mpl_toolkits.mplot3d.art3d import Line3DCollection
        ax.add_collection(Line3DCollection(segments, colors=colors,
                                           linestyle=linestyle))
        pts = trajs_np.reshape(-1, 3)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4)
        return
    ax.add_collection(mcoll.LineCollection(segments, colors=colors,
                                           linestyle=linestyle))
    pts = trajs_np.reshape(-1, 2)
    colors_scatter = []
    for t, c in zip(trajs_np, colors):
        colors_scatter.extend([c] * t.shape[0])
    ax.scatter(pts[:, 0], pts[:, 1], color=colors_scatter, s=4)
