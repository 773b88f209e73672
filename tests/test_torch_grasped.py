"""The grasped-object Panda in the port vs the JAX package on the same
numpy inputs: the box object and its orientation's Euler angles, the
kinematic model with the appended grasped link, the robot's collision
tables and margins, its collision points and Jacobians, the collision
check, and a MultiRobot with a grasped member (the three-arm system of
tests/test_multi_robot.py).

Tolerances: the object's points and q_to_euler of its orientation bit for
bit (the orientation sits at gimbal lock, where only the same float32
arithmetic gives the same fixed rotation); the grasped link's fixed
rotation and translation 1e-7; counts, margins and pair tables exactly;
points and Jacobians atol 1e-5 (metres, float32 FK in another order, as
tests/test_torch_kin.py); collision flags exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kin import export_jax_task
from test_torch_multi_robot import export_jax_multirobot_task
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.core.quaternion import q_to_euler as jax_q_to_euler
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.geom.objects import \
    GraspedObjectPandaBox as JGraspedObjectPandaBox
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_arrays, task_from_numpy
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.core.quaternion import q_to_euler
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.geom import (GraspedObject,
                                           GraspedObjectPandaBox)
from torch_robotics_tpu_torch.ops.lanes_fk import MultiRobotLayout
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda, RobotUR10
from torch_robotics_tpu_torch.tasks import PlanningTask

# tests/test_multi_robot.py:108-135: the grasped Panda's box, the bases
MR_BOX = (0.08, 0.08, 0.08)
MR_BASES = ((0.0, 0.6, 0.0), (0.0, -0.6, 0.0), (0.7, 0.0, 0.0))
MR_YAWS = (0.0, 0.0, np.pi / 2)


def export_grasped(jtask, export=export_jax_task):
    """``export`` of a JAX task whose robot (or MultiRobot members) may hold
    a grasped object, with the grasped points and the grasped link's
    name."""
    out = export(jtask)
    robots = (jtask.robot.robots if isinstance(jtask.robot, JMultiRobot)
              else [jtask.robot])
    targets = out["members"] if "members" in out else [out]
    for r, arrays in zip(robots, targets):
        if r.grasped_n_points > 0:
            arrays["grasped_points"] = np.asarray(r.grasped_points)
            arrays["link_name_grasped_object"] = r.link_name_grasped_object
    return out


def jax_grasped_task(cutoff=0.03, env=None, box=None):
    box = JGraspedObjectPandaBox() if box is None else box
    return JPlanningTask(env=JEnvSpheres3D() if env is None else env,
                         robot=JRobotPanda.create(grasped_object=box),
                         obstacle_cutoff_margin=cutoff)


def jax_grasped_multirobot_task():
    robot = JMultiRobot.create(
        [JRobotPanda.create(grasped_object=JGraspedObjectPandaBox(
            size=MR_BOX)), JRobotPanda.create(), JRobotUR10()],
        [(jz_rot(jnp.array(y, jnp.float32)), jnp.array(t, jnp.float32))
         for y, t in zip(MR_YAWS, MR_BASES)])
    return JPlanningTask(env=JEnvSpheres3D(), robot=robot,
                         obstacle_cutoff_margin=0.02)


def rand_q(lo, hi, n, seed):
    """q (n, d) over 1.4x the joint range: some joints past their
    clamps."""
    u = np.random.default_rng(seed).uniform(-0.2, 1.2, size=(n, lo.shape[0]))
    return (lo + u * (hi - lo)).astype(np.float32)


@pytest.fixture(scope="module")
def grasped():
    jtask = jax_grasped_task()
    robot = RobotPanda.create(
        grasped_object=GraspedObjectPandaBox(device="cpu"), device="cpu")
    ptask = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                         obstacle_cutoff_margin=0.03)
    return jtask, ptask


def test_box_points_and_orientation_bit_for_bit():
    jbox, box = JGraspedObjectPandaBox(), GraspedObjectPandaBox(device="cpu")
    assert isinstance(box, GraspedObject)
    assert box.n_base_points_for_collision == 14
    assert box.reference_frame == "panda_hand"
    np.testing.assert_array_equal(box.base_points_for_collision.numpy(),
                                  np.asarray(jbox.base_points_for_collision))
    np.testing.assert_array_equal(box.pos.numpy(), np.asarray(jbox.pos))
    np.testing.assert_array_equal(box.ori.numpy(), np.asarray(jbox.ori))
    rpy = q_to_euler(box.ori).numpy()
    np.testing.assert_array_equal(rpy, np.asarray(jax_q_to_euler(jbox.ori)))
    # gimbal lock: float32 pi, the float32 arcsin of the clipped -1
    np.testing.assert_array_equal(
        rpy, np.asarray([np.pi, -np.pi / 2, 0.0], np.float32))
    # the SDF of the box in its hand frame (rounded boxes, 1e-6 metres)
    x = np.random.default_rng(3).uniform(-0.2, 0.2, (64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        box.object_field.signed_distance(torch.as_tensor(x)).numpy(),
        np.asarray(jbox.object_field.signed_distance(jnp.asarray(x))),
        atol=1e-6)


def test_q_to_euler_matches_jax_off_gimbal_lock():
    """Random unit quaternions: the same formula in float32 (atan2 and
    arcsin implementations round differently by an ulp, 5e-7 rad)."""
    q = np.random.default_rng(0).normal(size=(256, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(q_to_euler(torch.as_tensor(q)).numpy(),
                               np.asarray(jax_q_to_euler(jnp.asarray(q))),
                               atol=5e-7)


def test_model_has_the_grasped_link(grasped):
    jtask, ptask = grasped
    jm, pm = jtask.robot.model, ptask.robot.model
    assert pm.n_links == jm.n_links == 12 and pm.n_dofs == 7
    assert list(pm.link_names) == list(jm.link_names)
    gi = pm.link_index("grasped_object")
    assert gi == 11 and pm.link_names[pm.parent_idx[gi]] == "panda_hand"
    assert pm.joint_types[gi] == 0
    for k in ("joint_fixed_rot", "joint_trans"):
        np.testing.assert_allclose(getattr(pm, k)[gi],
                                   np.asarray(getattr(jm, k))[gi], atol=1e-7)
    for k in ("joint_trans", "joint_fixed_rot", "joint_axis", "clamp_lower",
              "clamp_upper"):
        np.testing.assert_array_equal(getattr(pm, k),
                                      np.asarray(getattr(jm, k)))
    assert tuple(pm.parent_idx) == tuple(jm.parent_idx)


def test_collision_tables_and_margins(grasped):
    jtask, ptask = grasped
    jr, pr = jtask.robot, ptask.robot
    assert pr.grasped_n_points == jr.grasped_n_points == 14
    assert pr.link_name_grasped_object == "grasped_object"
    np.testing.assert_array_equal(pr.grasped_points.numpy(),
                                  np.asarray(jr.grasped_points))
    assert pr.object_margins.shape == (19,)
    np.testing.assert_array_equal(pr.object_margins.numpy(),
                                  np.asarray(jr.object_margins))
    assert len(pr.self_pair_idxs) == 66
    assert pr.self_pair_idxs == tuple(map(tuple, jr.self_pair_idxs))
    np.testing.assert_array_equal(pr.self_margins.numpy(),
                                  np.asarray(jr.self_margins))
    assert pr.object_coll_idxs == tuple(jr.object_coll_idxs)
    assert pr.self_coll_idxs == tuple(jr.self_coll_idxs)
    # 10 link pairs, then 4 grasped links x 14 points at margin 0.05
    assert (pr.self_margins[10:] == np.float32(0.05)).all()
    assert (pr.object_margins[5:] == np.float32(0.001)).all()


def test_learned_net_with_a_grasped_object_is_refused():
    with pytest.raises(AssertionError):
        JRobotPanda.create(grasped_object=JGraspedObjectPandaBox(),
                           use_learned_self_collision=True)
    with pytest.raises(ValueError, match="grasped"):
        RobotPanda.create(grasped_object=GraspedObjectPandaBox(device="cpu"),
                          use_learned_self_collision=True, device="cpu")


def test_collision_points_and_jacobians_match_jax(grasped):
    jtask, ptask = grasped
    m = ptask.robot.model
    q = rand_q(m.q_lower, m.q_upper, 40, seed=1)
    j_pts = np.asarray(jtask.robot.fk_map_collision(jnp.asarray(q)))
    p_pts = ptask.robot.fk_map_collision(torch.as_tensor(q))
    assert p_pts.shape == (40, 12 + 14, 3)
    np.testing.assert_allclose(p_pts.numpy(), j_pts, atol=1e-5)
    jp, jJ = jtask.robot.fk_map_collision_with_jac(jnp.asarray(q))
    pp, pJ = ptask.robot.fk_map_collision_with_jac(torch.as_tensor(q))
    assert pJ.shape == (40, 26, 3, 7)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(pJ.numpy(), np.asarray(jJ), atol=1e-5)
    # the selectors: links then the grasped points, points and Jacobians
    r, jr = ptask.robot, jtask.robot
    for sel, jsel in ((r.object_collision_points(pp),
                       jr.object_collision_points(jp)),
                      (r.self_collision_points(pp),
                       jr.self_collision_points(jp)),
                      (r.select_collision_jacobians(pJ, r.object_coll_idxs),
                       jr.select_collision_jacobians(jJ, jr.object_coll_idxs)),
                      (r.select_collision_jacobians(pJ, r.self_coll_idxs),
                       jr.select_collision_jacobians(jJ, jr.self_coll_idxs))):
        assert sel.shape == jsel.shape
        np.testing.assert_allclose(sel.numpy(), np.asarray(jsel), atol=1e-5)
    assert r.object_collision_points(pp).shape[-2] == 19
    assert r.self_collision_points(pp).shape[-2] == 8 + 14


def test_compute_collision_matches_jax(grasped):
    """Flags exactly, with the task's margins and with margin 0; the box
    changes some flags against the Panda without it."""
    jtask, ptask = grasped
    m = ptask.robot.model
    q = rand_q(m.q_lower, m.q_upper, 512, seed=2)
    x = np.concatenate([q, np.zeros_like(q)], -1)
    plain = PlanningTask(env=EnvSpheres3D(device="cpu"),
                         robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.03)
    for margin in (None, 0.0):
        ref = np.asarray(jtask.compute_collision(jnp.asarray(x),
                                                 margin=margin))
        got = ptask.compute_collision(torch.as_tensor(x),
                                      margin=margin).numpy()
        np.testing.assert_array_equal(got, ref)
        other = plain.compute_collision(torch.as_tensor(x),
                                        margin=margin).numpy()
        assert (got != other).any() and (got | ~other).all()
    trajs = torch.as_tensor(x[:64].reshape(4, 16, 14))
    assert ptask.compute_fraction_free_trajs(trajs) == pytest.approx(
        float(jtask.compute_fraction_free_trajs(jnp.asarray(trajs.numpy()))))


def test_convert_carries_the_grasped_points(grasped):
    jtask, ptask = grasped
    arrays = export_grasped(jtask)
    carried = task_from_numpy(arrays, device="cpu")
    for t in (carried, task_from_numpy(task_arrays(ptask), device="cpu")):
        assert t.robot.grasped_n_points == 14
        np.testing.assert_array_equal(t.robot.grasped_points.numpy(),
                                      ptask.robot.grasped_points.numpy())
        assert t.robot.link_name_grasped_object == "grasped_object"
    q = torch.as_tensor(rand_q(ptask.robot.model.q_lower,
                               ptask.robot.model.q_upper, 16, seed=3))
    assert torch.equal(carried.robot.fk_map_collision(q),
                       ptask.robot.fk_map_collision(q))


@pytest.fixture(scope="module")
def grasped_multirobot():
    jtask = jax_grasped_multirobot_task()
    return jtask, task_from_numpy(
        export_grasped(jtask, export_jax_multirobot_task), device="cpu")


def port_grasped_multirobot(device="cpu"):
    robot = MultiRobot.create(
        [RobotPanda.create(grasped_object=GraspedObjectPandaBox(
            size=MR_BOX, device=device), device=device),
         RobotPanda.create(device=device), RobotUR10(device=device)],
        [(z_rot(torch.tensor(y, dtype=torch.float32)), torch.tensor(t))
         for y, t in zip(MR_YAWS, MR_BASES)])
    return PlanningTask(env=EnvSpheres3D(device=device), robot=robot,
                        obstacle_cutoff_margin=0.02)


def test_multirobot_layout_with_a_grasped_member(grasped_multirobot):
    """Counts, pair table and margins of the MultiRobot follow JAX's
    (object sections 19 + 5 + 6, self sections 22 + 8 + 6); built from the
    URDFs it equals the carried task; its points and Jacobians match."""
    jtask, ptask = grasped_multirobot
    jr, pr = jtask.robot, ptask.robot
    assert pr.obj_counts == (19, 5, 6)
    assert pr.self_counts == (22, 8, len(jr.robots[2].self_coll_idxs))
    assert pr.self_pair_idxs == tuple(map(tuple, jr.self_pair_idxs))
    np.testing.assert_array_equal(pr.self_margins.numpy(),
                                  np.asarray(jr.self_margins))
    np.testing.assert_array_equal(pr.object_margins.numpy(),
                                  np.asarray(jr.object_margins))
    built = port_grasped_multirobot().robot
    assert built.self_pair_idxs == pr.self_pair_idxs
    np.testing.assert_array_equal(built.self_margins.numpy(),
                                  pr.self_margins.numpy())
    lo, hi = pr.q_min.numpy(), pr.q_max.numpy()
    q = rand_q(lo, hi, 16, seed=4)
    jp, jJ = jr.fk_map_collision_with_jac(jnp.asarray(q))
    pp, pJ = pr.fk_map_collision_with_jac(torch.as_tensor(q))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(pJ.numpy(), np.asarray(jJ), atol=1e-5)
    np.testing.assert_allclose(
        pr.fk_map_collision(torch.as_tensor(q)).numpy(),
        np.asarray(jr.fk_map_collision(jnp.asarray(q))), atol=1e-5)
    # the layout's point joints: the grasped points move with all 7 joints
    # of their Panda
    lay = MultiRobotLayout(ptask)
    pj = lay.point_joints()
    assert pj.shape == (sum(pr.obj_counts) + sum(pr.self_counts), 20)
    assert pj[5:19, :7].all() and not pj[5:19, 7:].any()
    x = np.concatenate([q, np.zeros_like(q)], -1)
    np.testing.assert_array_equal(
        ptask.compute_collision(torch.as_tensor(x)).numpy(),
        np.asarray(jtask.compute_collision(jnp.asarray(x))))
