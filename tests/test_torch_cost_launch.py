"""The value-only cost kernel's packed tables and launch shape
(``ops/terms_kernel.py``: ``pack_cost_params``, ``cost_launch_config``) on
the iLQR path's Panda, config 4's three arms (chip_smoke.MR_POSES), the
two-arm Panda + UR10 and config 4's arms at the tight poses: the block
fits the H100's shared memory, a chain stores no link transform, every
row of a lane goes to exactly one of its threads, and the threads' row
operations stay within 1.25x of their mean.  Past the caps a task keeps
its plain cost on the CPU, and its hook and the launch shape raise
NotImplementedError before any launch."""
import numpy as np
import pytest
import torch

from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
from torch_robotics_tpu_torch.ops.terms_kernel import (
    collision_cost_kernel_factory, cost_launch_config, cost_row_ops,
    pack_cost_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda, RobotUR10
from torch_robotics_tpu_torch.tasks import PlanningTask

SMEM_MAX = 232448
# (kind, base (x, y), yaw) per member, as chip_smoke.py places them
POSES = {
    "config4": (("panda", (0.2, 0.72), 0.0), ("panda", (0.2, -0.72), np.pi),
                ("ur10", (-0.75, 0.0), 0.0)),
    "two_arm": (("panda", (0.2, 0.55), 0.0), ("ur10", (0.2, -0.55), np.pi)),
    "tight": (("panda", (0.0, 0.5), 0.0), ("panda", (0.0, -0.5), np.pi),
              ("ur10", (-0.5, 0.0), 0.0)),
}
# a thread's row operations may pass the mean of its lane's threads by
# at most this factor (the static cut falls between whole rows)
BALANCE = 1.25


def multirobot(poses):
    make = {"panda": lambda: RobotPanda.create(device="cpu"),
            "ur10": lambda: RobotUR10(device="cpu")}
    return MultiRobot.create(
        [make[k]() for k, _, _ in poses],
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
          torch.tensor([x, y, 0.0])) for _, (x, y), yaw in poses])


def layout(name):
    if name == "ilqr_panda":
        task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                            robot=RobotPanda.create(device="cpu"),
                            obstacle_cutoff_margin=0.06)
        return TermsLayout(task)
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=multirobot(POSES[name]),
                        obstacle_cutoff_margin=0.02)
    return task.collision_residuals.obstacle_terms_lanes.plain.layout


@pytest.mark.parametrize("name", ["ilqr_panda"] + sorted(POSES))
def test_tables_and_launch_shape(name):
    lay = layout(name)
    ints, floats = pack_cost_params(lay)
    n_mem, D, P, NO, K, NOBJ = (int(v) for v in ints[:6])
    S, n_slots, T = (int(v) for v in ints[7:10])
    launch = cost_launch_config(ints, len(floats))
    assert launch["threads_per_lane"] == T
    assert launch["threads"] == launch["lanes"] * T <= 256
    assert launch["lanes"] % 32 == 0
    assert launch["smem_bytes"] == 4 * (
        -(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4
        + launch["lanes"] * (D + 3 * P + 12 * n_slots + T))
    assert launch["smem_bytes"] <= SMEM_MAX
    if name == "ilqr_panda":
        assert (n_mem, T, launch["lanes"]) == (1, 1, 128)
        assert (P, NO, K) == (9, 5, 10)
    else:
        assert n_mem == len(POSES[name]) <= T <= 8

    # every member is a chain: no stored transform, each step's parent the
    # step before it or the member's base
    steps = ints[16:16 + 8 * S].reshape(S, 8)
    src, slot = steps[:, 2], steps[:, 3]
    assert n_slots == 0 and (slot == -1).all()
    assert set(src.tolist()) <= {-1, -2} and (src == -1).sum() == n_mem

    # the rows: every one to exactly one thread, in order
    ops = cost_row_ops(lay)
    assert len(ops) == (NO if NOBJ else 0) + NO + K
    o = 16 + 8 * S + n_mem + 1 + P + NO + 2 * K
    cuts = ints[o:o + T + 1]
    assert cuts[0] == 0 and cuts[-1] == len(ops)
    assert (np.diff(cuts) >= 0).all()
    per_thread = np.array([ops[a:b].sum() for a, b in zip(cuts, cuts[1:])])
    assert per_thread.sum() == ops.sum()
    assert per_thread.max() <= BALANCE * per_thread.mean()


def test_other_lanes_a_block():
    """``lanes`` changes the block's lane count and its shared memory
    alone (D + 3 P + 12 slots + T floats a lane); the threads a lane, and
    so a lane's bits, stay."""
    ints, floats = pack_cost_params(layout("config4"))
    D, P, n_slots, T = (int(ints[i]) for i in (1, 2, 8, 9))
    base = cost_launch_config(ints, len(floats))
    other = cost_launch_config(ints, len(floats), lanes=32)
    assert other["lanes"] == 32 != base["lanes"]
    assert other["threads_per_lane"] == base["threads_per_lane"] == T
    assert other["smem_bytes"] - base["smem_bytes"] == 4 * (
        32 - base["lanes"]) * (D + 3 * P + 12 * n_slots + T)
    with pytest.raises(NotImplementedError, match="threads"):
        cost_launch_config(ints, len(floats), lanes=128)   # 512 threads


def test_past_the_caps_raises_before_any_launch():
    """Nine members (at most 8: phase 1 runs one member's FK a thread, at
    most 8 threads a lane): the task constructs on the CPU with its plain
    cost, and a tensor off the CPU (a meta tensor standing in for a CUDA
    one) raises at the cost hook and at a hook built by the factory alone,
    before any launch; a block that would not fit the shared memory raises
    in the launch shape."""
    task = PlanningTask(
        env=EnvSpheres3D(device="cpu"),
        robot=multirobot([("panda", (0.0, 0.8 * i), 0.0) for i in range(9)]),
        obstacle_cutoff_margin=0.02)
    q = torch.zeros((63, 2))
    meta = torch.zeros((63, 2), device="meta")
    for cost in (task.collision_residuals.collision_cost_lanes,
                 collision_cost_kernel_factory(task)):
        assert torch.equal(cost(q), cost.plain(q))
        with pytest.raises(NotImplementedError, match="at most 8 members"):
            cost(meta)
    ints, floats = pack_cost_params(layout("ilqr_panda"))
    big = ints.copy()
    big[2] = 20000                                   # collision points
    with pytest.raises(NotImplementedError, match="shared memory"):
        cost_launch_config(big, len(floats))
