"""The port's viz/ (host-side matplotlib on the Agg backend):
tests/test_viz.py's six cases on the port, and what the port draws held to
what the JAX package draws on the same inputs: every patch's vertices and
colours of EnvDense2D's and EnvSpheres3D's scenes and of a posed 2-D
object, the collision colouring of point-mass trajectories
(``trajs_collision_masks``) with their segments, render_env_sdf's filled
contours (levels, and each path's vertices to 1e-5) and
render_env_grad_sdf's arrows, and the Panda's skeleton lines."""
import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_robotics_tpu.viz as jviz  # noqa: E402
from torch_robotics_tpu.envs import EnvBase as JEnvBase  # noqa: E402
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D  # noqa: E402
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D  # noqa
from torch_robotics_tpu.geom.sdf import MultiBoxField as JMultiBoxField
from torch_robotics_tpu.geom.sdf import ObjectField as JObjectField
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda  # noqa: E402
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvBase, EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.geom import build_occupancy_map
from torch_robotics_tpu_torch.geom.sdf import MultiBoxField, ObjectField
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.viz import (PlanningVisualizer,
                                          create_fig_and_axes,
                                          plot_coordinate_frame, render_env,
                                          render_env_grad_sdf,
                                          render_env_sdf, render_robot)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# --- tests/test_viz.py's cases on the port ---------------------------------
def test_render_env_2d():
    env = EnvDense2D(device="cpu")
    fig, ax = create_fig_and_axes(2)
    render_env(env, ax)
    render_env_sdf(env, ax, fig, steps=50)


def _line_trajs(n_way):
    """(2, n_way, 2) straight lines from (-0.9, -0.9) to (0.9, 0.9)."""
    line = np.linspace([-0.9, -0.9], [0.9, 0.9], n_way, dtype=np.float32)
    return np.tile(line[None], (2, 1, 1))


def test_visualizer_point_mass(tmp_path):
    task = PlanningTask(env=EnvDense2D(device="cpu"),
                        robot=RobotPointMass.create(device="cpu"))
    viz = PlanningVisualizer(task=task)
    trajs = torch.as_tensor(_line_trajs(8))
    fig, ax = viz.render_robot_trajectories(
        trajs=trajs, start_state=trajs[0, 0], goal_state=trajs[0, -1])
    out = tmp_path / "trajs.png"
    fig.savefig(out)
    assert out.stat().st_size > 0
    fig2, axs = viz.plot_joint_space_state_trajectories(trajs=trajs)
    assert axs.shape == (2, 2)


def test_visualizer_animation(tmp_path):
    task = PlanningTask(env=EnvDense2D(device="cpu"),
                        robot=RobotPointMass.create(device="cpu"))
    viz = PlanningVisualizer(task=task)
    trajs = torch.as_tensor(_line_trajs(5)[:1])
    path = viz.animate_robot_trajectories(
        trajs=trajs, video_filepath=str(tmp_path / "anim.gif"), n_frames=3,
        anim_time=1.0)
    assert path == str(tmp_path / "anim.gif")
    assert (tmp_path / "anim.gif").stat().st_size > 0


def test_animate_execution(tmp_path):
    """Executed trajectories drawn with their collision spheres, the robot
    that reported contact red from its contact step on."""
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(device="cpu"))
    viz = PlanningVisualizer(task=task)
    qpos = torch.linspace(0.0, 0.3, 3)[None, :, None].expand(2, 3, 7)
    out = viz.animate_execution(
        qpos, contact=np.array([False, True]),
        contact_step=np.array([-1, 1]),
        video_filepath=str(tmp_path / "exec.gif"), anim_time=1.0)
    assert out == str(tmp_path / "exec.gif")
    assert (tmp_path / "exec.gif").stat().st_size > 0


def test_occupancy_map_plot(tmp_path):
    env = EnvDense2D(device="cpu")
    occ = build_occupancy_map(env.limits, 0.05, env.obj_fixed_list,
                              device="cpu")
    occ.plot(save_path=str(tmp_path / "occ.png"))
    assert (tmp_path / "occ.png").stat().st_size > 0


def test_render_panda_3d():
    fig, ax = create_fig_and_axes(3)
    render_env(EnvSpheres3D(device="cpu"), ax)
    render_robot(RobotPanda.create(device="cpu"), ax, q=torch.zeros(7))
    plot_coordinate_frame(ax, np.eye(3), np.zeros(3))


# --- the drawn data against the JAX package's -------------------------------
def _patches(ax):
    """(vertices in display coordinates, face colour) of every patch."""
    ax.figure.canvas.draw()
    return [(p.get_verts(), np.asarray(p.get_facecolor())) for p in
            ax.patches]


def _hold_patches(got, ref):
    assert len(got) == len(ref) > 0
    for (v, c), (rv, rc) in zip(got, ref):
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_allclose(v, rv, atol=TOL)


def _posed_box_envs():
    """A rounded-box 2-D object turned 0.4 rad about z at (0.1, -0.2): the
    two packages' envs."""
    c, s = float(np.cos(0.2)), float(np.sin(0.2))
    kw = dict(pos=[0.1, -0.2, 0.0], ori=[c, 0.0, 0.0, s])
    box = ([[0.2, 0.1], [-0.3, 0.4]], [[0.2, 0.3], [0.1, 0.25]])
    env = EnvBase(limits=[[-1, -1], [1, 1]], device="cpu", obj_fixed_list=[
        ObjectField.create([MultiBoxField(*box, device="cpu")], **kw,
                           device="cpu")])
    jenv = JEnvBase(limits=[[-1, -1], [1, 1]], obj_fixed_list=[
        JObjectField.create([JMultiBoxField(*box)], **kw)])
    return env, jenv


@pytest.mark.parametrize("scene", ["dense2d", "posed_boxes", "spheres3d"])
def test_scene_patches_match_jax(scene):
    env, jenv = {"dense2d": lambda: (EnvDense2D(device="cpu"),
                                     JEnvDense2D()),
                 "posed_boxes": _posed_box_envs,
                 "spheres3d": lambda: (EnvSpheres3D(device="cpu"),
                                       JEnvSpheres3D())}[scene]()
    out = []
    for e, render in ((env, render_env), (jenv, jviz.render_env)):
        fig, ax = create_fig_and_axes(e.dim)
        render(e, ax)
        if e.dim == 3:       # spheres as surfaces: their drawn polygons
            fig.canvas.draw()
            out.append([np.concatenate([p.vertices for p in c.get_paths()])
                        for c in ax.collections])
        else:
            out.append(_patches(ax))
    if env.dim == 3:
        assert len(out[0]) == len(out[1]) > 0
        for a, b in zip(*out):
            np.testing.assert_allclose(a, b, atol=TOL)
    else:
        _hold_patches(*out)


def test_trajectory_colours_and_segments_match_jax():
    """Collision-coloured point-mass trajectories: some collide, some are
    free; the colours come from each package's trajs_collision_masks."""
    n_way = 16
    starts = np.float32([[-0.9, -0.9], [-0.95, 0.95], [0.9, -0.9],
                         [-0.95, -0.1]])
    ends = np.float32([[0.9, 0.9], [-0.95, -0.95], [0.95, 0.95],
                       [-0.95, 0.5]])
    pos = np.linspace(starts, ends, n_way, axis=1)          # (4, H, 2)
    trajs = np.concatenate([pos, np.zeros_like(pos)], -1)
    task = PlanningTask(env=EnvDense2D(device="cpu"),
                        robot=RobotPointMass.create(device="cpu"))
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create())
    drawn = []
    for viz, t in ((PlanningVisualizer(task=task), torch.as_tensor(trajs)),
                   (jviz.PlanningVisualizer(task=jtask), jnp.asarray(trajs))):
        fig, ax = viz.render_robot_trajectories(
            trajs=t, start_state=t[0, 0], goal_state=t[0, -1])
        lines = ax.collections[0]
        drawn.append((np.asarray(lines.get_colors()),
                      np.stack(lines.get_segments()), _patches(ax)))
    (c, seg, patches), (rc, rseg, rpatches) = drawn
    np.testing.assert_array_equal(c, rc)
    assert len({tuple(x) for x in c}) == 2      # both colours present
    np.testing.assert_allclose(seg, rseg, atol=TOL)
    _hold_patches(patches, rpatches)


def test_sdf_contours_and_gradients_match_jax():
    env, jenv = EnvDense2D(device="cpu"), JEnvDense2D()
    out = []
    for e, sdf, grad in ((env, render_env_sdf, render_env_grad_sdf),
                         (jenv, jviz.render_env_sdf,
                          jviz.render_env_grad_sdf)):
        fig, ax = create_fig_and_axes(2)
        sdf(e, ax, fig, steps=60)
        ctf = ax.collections[0]
        grad(e, ax, fig, steps=20)
        q = ax.collections[-1]
        out.append((np.asarray(ctf.levels), ctf.get_paths(),
                    np.stack([q.U, q.V])))
    (lv, paths, uv), (rlv, rpaths, ruv) = out
    np.testing.assert_allclose(lv, rlv, atol=TOL)
    assert len(paths) == len(rpaths)
    for p, r in zip(paths, rpaths):
        assert p.vertices.shape == r.vertices.shape
        np.testing.assert_allclose(p.vertices, r.vertices, atol=TOL)
    np.testing.assert_allclose(uv, ruv, atol=TOL)


def test_panda_skeleton_matches_jax():
    q = np.float32([0.3, -0.5, 0.2, -1.6, 0.1, 1.2, 0.4])
    out = []
    for robot, draw, qq in ((RobotPanda.create(device="cpu"), render_robot,
                             torch.as_tensor(q)),
                            (JRobotPanda.create(), jviz.render_robot,
                             jnp.asarray(q))):
        fig, ax = create_fig_and_axes(3)
        draw(robot, ax, q=qq)
        out.append([np.stack(line.get_data_3d()) for line in ax.lines])
    assert len(out[0]) == len(out[1]) > 0
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_render_methods_match_jax():
    """The render methods: an env's render / render_sdf / render_grad_sdf
    (EnvPlanar2Link, with the planar arm drawn) and a grasped box's render
    in 3-D draw what the JAX package's methods draw."""
    from torch_robotics_tpu.envs import EnvPlanar2Link as JEnvPlanar2Link
    from torch_robotics_tpu.geom import \
        GraspedObjectPandaBox as JGraspedObjectPandaBox
    from torch_robotics_tpu.robots import RobotPlanar2Link as JRobotPlanar2Link
    from torch_robotics_tpu_torch.envs import EnvPlanar2Link
    from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
    from torch_robotics_tpu_torch.robots import RobotPlanar2Link
    q = np.float32([0.3, -0.7])
    out = []
    for env, robot, box, draw, qq in (
            (EnvPlanar2Link(device="cpu"), RobotPlanar2Link.create(
                device="cpu"), GraspedObjectPandaBox(device="cpu"),
             render_robot, torch.as_tensor(q)),
            (JEnvPlanar2Link(), JRobotPlanar2Link.create(),
             JGraspedObjectPandaBox(), jviz.render_robot, jnp.asarray(q))):
        fig, ax = create_fig_and_axes(2)
        env.render(ax)
        env.render_sdf(ax, fig)
        env.render_grad_sdf(ax, fig)
        draw(robot, ax, q=qq)
        lines = [np.stack(line.get_data()) for line in ax.lines]
        quiver = [c for c in ax.collections if hasattr(c, "U")][-1]
        uv = np.stack([quiver.U, quiver.V])
        fig3, ax3 = create_fig_and_axes(3)
        box.render(ax3)
        fig3.canvas.draw()
        out.append((_patches(ax), lines, uv, [np.concatenate(
            [p.vertices for p in c.get_paths()]) for c in ax3.collections]))
    (patches, lines, uv, box), (rpatches, rlines, ruv, rbox) = out
    _hold_patches(patches, rpatches)
    assert len(lines) == len(rlines) == 2
    for a, b in zip(lines + box, rlines + rbox):
        np.testing.assert_allclose(a, b, atol=TOL)
    np.testing.assert_allclose(uv, ruv, atol=TOL)
