"""The launch side of the CUDA MultiRobot terms kernel (``csrc/mr_terms.cu``,
``ops/terms_kernel.py``: ``pack_multirobot_params``,
``mr_terms_launch_config``) without a GPU, on config 4's three arms
(chip_smoke.MR_POSES), the same arms at the tight poses, with the first
Panda holding config 4's grasped box, and in a grid scene:

- the block (32 lanes, one warp a block pair) fits the H100's 232,448
  bytes of shared memory, and past the caps the launch shape raises;
- the row entries: each diagonal block lists its object points' SDF and
  workspace rows, its own pairs and its side of every mutual row, each
  cross block its mutual rows, the pair's points ordered member i first;
  the value phase's cuts cover every row once, balanced;
- what lets the kernel add only the active rows: in a float32 model of
  the kernel's order (``test_torch_multi_robot.model_mr_terms``), the
  block pairs' sums over their active rows are the sums over every row,
  bit for bit (values; signed zeros compare equal), on uniform q over
  the joint limits, where 5-8% of the rows are active."""
import numpy as np
import pytest
import torch

from test_torch_multi_robot import mr_sections, model_mr_terms, rand_q
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
from torch_robotics_tpu_torch.ops.terms_kernel import (
    cost_row_ops, mr_terms_launch_config, pack_multirobot_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda, RobotUR10
from torch_robotics_tpu_torch.tasks import PlanningTask

SMEM_MAX = 232448
# (kind, base (x, y), yaw) per member, as chip_smoke.py places them
CONFIG4 = (("panda", (0.2, 0.72), 0.0), ("panda", (0.2, -0.72), np.pi),
           ("ur10", (-0.75, 0.0), 0.0))
TIGHT = (("panda", (0.0, 0.5), 0.0), ("panda", (0.0, -0.5), np.pi),
         ("ur10", (-0.5, 0.0), 0.0))
# chip_smoke.GRASP_MR_BOX: config 4's first Panda holds a 0.08 m box
BOX = (0.08, 0.08, 0.08)
# a thread's row operations may pass the mean of the block's threads by at
# most this factor (the static cut falls between whole rows)
BALANCE = 1.5


def _task(poses=CONFIG4, grasp=False, env=None):
    make = {"panda": lambda: RobotPanda.create(device="cpu"),
            "ur10": lambda: RobotUR10(device="cpu")}
    members = [make[k]() for k, _, _ in poses]
    if grasp:
        members[0] = RobotPanda.create(
            grasped_object=GraspedObjectPandaBox(size=BOX, device="cpu"),
            device="cpu")
    robot = MultiRobot.create(
        members, [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
                   torch.tensor([x, y, 0.0])) for _, (x, y), yaw in poses])
    return PlanningTask(env=EnvSpheres3D(device="cpu") if env is None
                        else env, robot=robot, obstacle_cutoff_margin=0.02)


@pytest.fixture(scope="module")
def tasks():
    grid = EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.05,
                        device="cpu")
    return {"config4": _task(), "tight": _task(TIGHT),
            "grasped": _task(grasp=True), "grid": _task(env=grid)}


def _packed(task):
    return pack_multirobot_params(
        task.collision_residuals.obstacle_terms_lanes.plain.layout)


@pytest.mark.parametrize("name", ["config4", "grasped", "grid"])
def test_block_fits_the_card(tasks, name):
    """32 lanes a block, one warp a block pair (6 for three arms), within
    the shared memory a block can have; the hook carries this shape."""
    hook = tasks[name].collision_residuals.obstacle_terms_lanes
    ints, floats = _packed(tasks[name])
    launch = mr_terms_launch_config(ints, len(floats))
    assert launch == hook.params[4] and hook.refusal is None
    assert launch["lanes"] == 32 and launch["block_pairs"] == 6
    assert launch["threads"] == 192 <= 320
    assert launch["smem_bytes"] <= SMEM_MAX
    # the grasped arms' 66 points and 381 rows take the largest block
    if name == "grasped":
        a = mr_sections(ints, floats)
        assert (a["P"], 2 * a["NO"] + a["K"]) == (66, 381)


def test_launch_shape_raises_past_the_caps(tasks):
    """A block past the shared memory, or past 320 threads (64 lanes of 6
    block pairs), raises before any launch; 64 lanes fit two members."""
    ints, floats = _packed(tasks["config4"])
    big = ints.copy()
    big[2] = 20000                                   # collision points
    with pytest.raises(NotImplementedError, match="shared memory"):
        mr_terms_launch_config(big, len(floats))
    with pytest.raises(NotImplementedError, match="384 threads"):
        mr_terms_launch_config(ints, len(floats), lanes=64)
    two = _task(CONFIG4[:2])
    i2, f2 = _packed(two)
    assert mr_terms_launch_config(i2, len(f2), lanes=64)["threads"] == 192


@pytest.mark.parametrize("name", ["config4", "grasped"])
def test_row_entries_follow_the_blocks(tasks, name):
    """Every object row and own pair is listed once, on its member's
    diagonal block; every mutual row three times: on its cross block
    (counting its cost) and as a side on both members' diagonal blocks
    (not counting it), its points ordered so that the first lies on the
    block's first member.  The value cuts cover the rows in order, within
    BALANCE of the mean operation count."""
    task = tasks[name]
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    ints, floats = _packed(task)
    a = mr_sections(ints, floats)
    n_rows = 2 * a["NO"] + a["K"]
    obj_off = [int(v) for v in lay.obj_off]

    def member(p):
        if p < obj_off[-1]:
            return int(np.searchsorted(obj_off, p, side="right")) - 1
        return int(np.searchsorted(lay.self_off, p, side="right")) - 1

    seen = {}
    for w in range(a["n_bp"]):
        i, j = a["bp_i"][w], a["bp_j"][w]
        for e in a["entries"][a["bp_begin"][w]:a["bp_begin"][w + 1]]:
            row, flags = e >> 3, e & 7
            seen.setdefault(row, []).append((w, flags))
            if row < 2 * a["NO"]:
                assert i == j and flags == 0
                assert member(a["obj_pt"][row % a["NO"]]) == i
                continue
            k = row - 2 * a["NO"]
            pa, pb = a["pair_a"][k], a["pair_b"][k]
            if flags & 1:
                pa, pb = pb, pa
            if i == j and not flags & 4:                # an own pair
                assert flags == 0 and member(pa) == member(pb) == i
            elif i == j:                                # a side
                mi, mj = member(pa), member(pb)
                assert mi < mj and i == (mj if flags & 2 else mi)
            else:
                assert flags in (0, 1) and (member(pa), member(pb)) == (i, j)
    assert sorted(seen) == list(range(n_rows))
    for row, where in seen.items():
        blocks = sorted(w for w, _ in where)
        if len(where) == 3:                              # a mutual row
            assert sum(not f & 4 for _, f in where) == 1
            assert blocks[2] >= a["n_mem"] > blocks[1]
        else:
            assert len(where) == 1 and blocks[0] < a["n_mem"]
    cuts = a["vcuts"]
    assert cuts[0] == 0 and cuts[-1] == n_rows and (np.diff(cuts) >= 0).all()
    ops = cost_row_ops(lay)
    per = np.array([ops[c0:c1].sum() for c0, c1 in zip(cuts, cuts[1:])])
    assert per.max() <= BALANCE * per.mean()


@pytest.mark.parametrize("name", ["config4", "tight", "grasped"])
def test_active_rows_give_the_sums_over_every_row(tasks, name):
    """The float32 model of the kernel's order: adding only the active
    rows (r != 0), as the kernel does, gives the bits of adding every row,
    where an inactive row's Jacobian is -0 * J = +-0."""
    task = tasks[name]
    ints, floats = _packed(task)
    q = rand_q(task.robot, 48, seed=11)
    r = task.collision_residuals.obstacle_terms_lanes.plain.rows(
        torch.as_tensor(q))[0]
    assert bool((r > 0).any()) and not bool((r > 0).all())
    active = model_mr_terms(ints, floats, q, np.float32)
    every = model_mr_terms(ints, floats, q, np.float32, every_row=True)
    for x, y in zip(active, every):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
