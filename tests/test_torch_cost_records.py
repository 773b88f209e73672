"""K8's own sections of the cost kernel's packing
(``ops/terms_kernel.py``: ``pack_cost_kernel_params``): each FK step's class
(``_step_class``: a coordinate-axis joint, an identity parent, a fixed
joint with F = I, a step whose R a later step or an offset point reads)
and each pair row's record (a, b, margin, guard), located by the header's
ints 14 and 15; the launch shape and shared memory that follow on the
pair-field, grid and grasped Panda and on config 4 (plain and grasped);
and the terms kernels' packings (``pack_terms_params``,
``pack_multirobot_params``), which start from ``pack_cost_params``, left
as they were: K8's sections go to its own buffers only."""
import dataclasses
import hashlib

import numpy as np
import pytest

from test_torch_cost_launch import layout
from test_torch_grasped import port_grasped_multirobot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
from torch_robotics_tpu_torch.ops.terms_kernel import (
    cost_launch_config, pack_cost_kernel_params, pack_cost_params,
    pack_multirobot_params, pack_terms_params)
from torch_robotics_tpu_torch.robots import RobotPanda, RobotUR10
from torch_robotics_tpu_torch.tasks import PlanningTask

F32 = np.float32
# cost.cu's step class bits
X, Y, Z, NEG, KEEP_R, ID_PARENT, ID_F = 1, 2, 3, 4, 8, 16, 32
# the Panda's chain: link 0 fixed (F = I) on the identity base, links 1-7
# about +z (link 1's parent rotation exactly I), link 8 fixed (F = I),
# link 9 the last (its R unread) or, holding a box, link 11's parent
PANDA = [ID_PARENT | KEEP_R, ID_PARENT | KEEP_R | Z] + [KEEP_R | Z] * 6 + [
    ID_F | KEEP_R]
# the UR10: link 0 fixed (F = I), then z, y, y, y, z, y
UR10 = [ID_PARENT | KEEP_R, ID_PARENT | KEEP_R | Z] + [KEEP_R | Y] * 3 + [
    KEEP_R | Z, Y]


def _task(robot, env=None):
    return PlanningTask(env=env or EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.06)


def single(name):
    if name == "panda":
        return TermsLayout(_task(RobotPanda.create(device="cpu")))
    if name == "grasped":
        return TermsLayout(_task(RobotPanda.create(
            grasped_object=GraspedObjectPandaBox(device="cpu"),
            device="cpu")))
    if name == "grid":
        env = EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.2,
                           device="cpu")
        return TermsLayout(_task(RobotPanda.create(device="cpu"), env))
    return TermsLayout(_task(RobotUR10(device="cpu")))


def multi(name):
    if name == "config4":
        return layout("config4")
    task = port_grasped_multirobot()
    return task.collision_residuals.obstacle_terms_lanes.plain.layout


def classes(ints):
    return ints[ints[14]:ints[14] + int(ints[7])].tolist()


@pytest.mark.parametrize("name,want", [
    ("panda", PANDA + [0]), ("grasped", PANDA + [KEEP_R, KEEP_R]),
    ("grid", PANDA + [0]), ("ur10", UR10)])
def test_step_classes(name, want):
    lay = single(name)
    ints, _ = pack_cost_kernel_params(lay)
    assert classes(ints) == want
    m = lay.model
    for c, i in zip(classes(ints), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11]):
        if c & 3:                     # the axis the class names
            axis = np.zeros(3, F32)
            axis[(c & 3) - 1] = -1 if c & NEG else 1
            np.testing.assert_array_equal(m.joint_axis[i], axis)


def test_step_classes_of_config4():
    """Member 0 stands at yaw 0 (its base rotation exactly I), member 1 at
    yaw pi (not exactly I: its root keeps F = I only), the UR10 at yaw
    0."""
    ints, _ = pack_cost_kernel_params(multi("config4"))
    assert classes(ints) == (PANDA + [0] + [ID_F | KEEP_R]
                             + [KEEP_R | Z] * 7 + [ID_F | KEEP_R, 0] + UR10)


def test_step_classes_of_other_axes_and_a_branching_tree():
    """A Panda with every joint about -y, and one whose links 7 and 9 hang
    from links 3 and 5: a stored transform's R is read later."""
    robot = RobotPanda.create(device="cpu")
    axis = np.array(robot.model.joint_axis)
    axis[[i for i, t in enumerate(robot.model.joint_types) if t == 1]] = (
        0, -1, 0)
    neg_y = dataclasses.replace(robot, model=dataclasses.replace(
        robot.model, joint_axis=axis.astype(F32)))
    ints, _ = pack_cost_kernel_params(TermsLayout(_task(neg_y)))
    assert classes(ints)[1:8] == [ID_PARENT | KEEP_R | Y | NEG] + [
        KEEP_R | Y | NEG] * 6
    parent = list(robot.model.parent_idx)
    parent[7], parent[9] = 3, 5
    branching = dataclasses.replace(robot, model=dataclasses.replace(
        robot.model, parent_idx=tuple(parent)))
    ints, _ = pack_cost_kernel_params(TermsLayout(_task(branching)))
    S = int(ints[7])
    steps = ints[16:16 + 8 * S].reshape(S, 8)
    for c, slot in zip(classes(ints), steps[:, 3]):
        assert slot < 0 or c & KEEP_R


@pytest.mark.parametrize("name,want", [
    # link 0 t = tr + tp 3, link 1 about z under I 20 + 3, links 2-7 20 +
    # t 18 + R Rl 45, link 8 (F = I) t 18, link 9 (R unread) t 18
    ("panda", 3 + 23 + 6 * 83 + 18 + 18),
    # links 9 and 11 read R (t 18 + R Rl 45); 14 grasped points R o + t
    ("grasped", 3 + 23 + 6 * 83 + 18 + 2 * 63 + 14 * 18),
    # links 2-4 about y and 5 about z read R, link 6's R unread (20 + 18)
    ("ur10", 3 + 23 + 4 * 83 + 38),
    # the Panda; the second Panda's root under a base rotation not exactly
    # I keeps F = I (t 18), links 1-7 83 each, 8 and 9 t 18; the UR10
    ("config4", 560 + 18 + 7 * 83 + 2 * 18 + 396)])
def test_cost_bound_counts_fk_by_class(name, want):
    """chip_smoke.py's bound for K8 counts each packed FK step's operations
    by its class (``cost_fk_ops``), not a flat count a link."""
    import chip_smoke
    lay = multi(name) if name == "config4" else single(name)
    assert chip_smoke.cost_fk_ops(lay) == want


@pytest.mark.parametrize("name", ["panda", "grasped", "config4",
                                  "grasped_config4"])
def test_pair_records(name):
    lay = single(name) if name in ("panda", "grasped") else multi(name)
    ints, floats = pack_cost_kernel_params(lay)
    K = int(ints[4])
    at = int(ints[15])
    assert at % 4 == 0 and at >= ints[14] + ints[7]
    assert at + 4 * K == len(ints)
    rec = ints[at:].reshape(K, 4)
    np.testing.assert_array_equal(rec[:, 0], lay.pair_a)
    np.testing.assert_array_equal(rec[:, 1], lay.pair_b)
    m = lay.self_margins.numpy().astype(F32)
    np.testing.assert_array_equal(rec[:, 2].view(F32), m)
    # the guard is cost.cu's old expression m * m * 1.000001f, rounded
    # after each product
    guard = rec[:, 3].view(F32)
    for mi, g in zip(m, guard):
        assert g == F32(F32(mi * mi) * F32(1.000001))
        assert g > mi * mi


@pytest.mark.parametrize("name,want", [
    ("panda", (128, 1, 19840)), ("grid", (128, 1, 19712)),
    ("grasped", (128, 1, 43408)), ("config4", (64, 4, 42368)),
    ("grasped_config4", (32, 6, 42384))])
def test_launch_shape_and_shared_bytes(name, want):
    """The launch shape is the parent's (T, lanes a block); the block's
    shared memory grows by K8's sections alone: the parameters, rounded to
    16 bytes each, and per lane its q, points, stored transforms and T
    partial sums."""
    lay = multi(name) if "config4" in name else single(name)
    ints, floats = pack_cost_kernel_params(lay)
    c_ints, c_floats = pack_cost_params(lay)
    launch = cost_launch_config(ints, len(floats))
    base = cost_launch_config(c_ints, len(c_floats))
    assert (launch["lanes"], launch["threads_per_lane"],
            launch["smem_bytes"]) == want
    assert (launch["lanes"], launch["threads_per_lane"]) == (
        base["lanes"], base["threads_per_lane"])
    assert launch["smem_bytes"] - base["smem_bytes"] == 4 * (
        -(-len(ints) // 4) - -(-len(c_ints) // 4)) * 4


# sha256 (first 16 hex digits) of the terms kernels' int buffers, the
# words K1 and K5 read: K8's own sections must not move them
TERMS_INTS = {"panda": "5711b724f336292d", "grasped": "482b6bb7ecf4f767",
              "config4": "b9e9dd699ec76d16",
              "grasped_config4": "ec45ec71001a7a81"}


@pytest.mark.parametrize("name", sorted(TERMS_INTS))
def test_terms_packings_unchanged(name):
    """K1's and K5's buffers are the words they read before K8's sections
    existed; K8's buffers are the same cost packing with ints 14-15
    pointing past it, and its floats are the same."""
    if name in ("panda", "grasped"):
        lay = single(name)
        ints, floats = pack_terms_params(lay)
    else:
        lay = (multi(name) if name == "config4"
               else _grasped_config4_at_chip_smoke_poses())
        ints, floats = pack_multirobot_params(lay)
    digest = hashlib.sha256(np.ascontiguousarray(ints, np.int32)
                            .tobytes()).hexdigest()[:16]
    assert digest == TERMS_INTS[name]
    c_ints, c_floats = pack_cost_params(lay)
    k_ints, k_floats = pack_cost_kernel_params(lay)
    np.testing.assert_array_equal(ints[:len(c_ints)][:13], c_ints[:13])
    np.testing.assert_array_equal(ints[14:len(c_ints)], c_ints[14:])
    assert (c_ints[14], c_ints[15]) == (0, 0)
    np.testing.assert_array_equal(k_ints[:14], c_ints[:14])
    np.testing.assert_array_equal(k_ints[16:len(c_ints)], c_ints[16:])
    assert k_ints[14] == len(c_ints)
    np.testing.assert_array_equal(floats, c_floats)
    np.testing.assert_array_equal(k_floats, c_floats)


def _grasped_config4_at_chip_smoke_poses():
    """Config 4 at chip_smoke.py's poses with its first Panda holding the
    default box."""
    import torch

    from test_torch_cost_launch import POSES
    from torch_robotics_tpu_torch.core import z_rot
    from torch_robotics_tpu_torch.robots import MultiRobot
    members = [RobotPanda.create(
        grasped_object=GraspedObjectPandaBox(device="cpu"), device="cpu"),
        RobotPanda.create(device="cpu"), RobotUR10(device="cpu")]
    robot = MultiRobot.create(members, [
        (z_rot(torch.tensor(yaw, dtype=torch.float32)),
         torch.tensor([x, y, 0.0])) for _, (x, y), yaw in POSES["config4"]])
    task = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.02)
    return task.collision_residuals.obstacle_terms_lanes.plain.layout


@pytest.mark.parametrize("lanes", [32, 64, 96, 128, 160])
def test_lanes_a_block_are_the_built_ones(lanes):
    """cost.cu is built for 32, 64, 96 and 128 lanes a block (its lane
    stride a compile-time constant): the launch shape takes those and
    refuses another count before any launch."""
    ints, floats = pack_cost_kernel_params(single("panda"))
    if lanes == 160:
        with pytest.raises(NotImplementedError, match="built for"):
            cost_launch_config(ints, len(floats), lanes=lanes)
        return
    launch = cost_launch_config(ints, len(floats), lanes=lanes)
    assert (launch["lanes"], launch["threads_per_lane"]) == (lanes, 1)
