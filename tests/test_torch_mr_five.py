"""A MultiRobot past four members, on the CPU, against the JAX package:
five Pandas on a circle of 0.6 m at z = -0.7, each facing its centre, in
EnvSpheres3D at cutoff 0.02 (d = 35, 350 rows; chip_smoke.py's phase
``mr_five``, MR_CELLS; tests/test_torch_mr_refused.py holds five Pandas on
a line to the JAX package too).

Its 15 block pairs pass the 10 warps a block of the CUDA MultiRobot terms
kernel, so a warp walks block pairs w, w + 10 and its value phase's row
cuts are 10 ranges; a model of that schedule on the packed buffers covers
every block pair and every row once, and the float models of K5 (float64)
and K8 (float32, eight threads a lane) on their buffers give the plain
terms and cost.  A float32 model of K5's order adds only the active rows
and gives the bits of adding every row.  Residuals, Jacobians and the GN
terms in the solver layout match the JAX package's.  A ninth member passes
both kernels' caps (8 members), refused in each kernel's words on a tensor
off the CPU.

Tolerances: residuals and Jacobians atol 1e-5 (metres), GN terms atol
3e-5 * max|ref| plus rtol 2e-5 (tests/test_torch_multi_robot.py); the K5
model 1e-7 of max|ref| in float64 (float32 margins in the packing); the K8
model at the terms tolerance; the active-row model bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cost_schedule import model_cost
from test_torch_multi_robot import (_close_terms, model_mr_terms,
                                    mr_sections, rand_q)
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as jax_mr_terms_factory
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.ops.terms_kernel import (
    cost_row_ops, mr_terms_launch_config, pack_cost_kernel_params,
    pack_multirobot_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask

SMEM_MAX = 232448
# a warp's row range may pass the mean of the block's by at most this
# factor (the static cut falls between whole rows)
BALANCE = 1.5


# each Panda's base (x, y, z) and yaw (chip_smoke.py MR_CELLS["mr_five"])
POSES = tuple(((0.6 * np.cos(a), 0.6 * np.sin(a), -0.7), a + np.pi)
              for a in 2 * np.pi * np.arange(5) / 5)


@pytest.fixture(scope="module")
def tasks():
    jrobot = JMultiRobot.create(
        [JRobotPanda.create() for _ in POSES],
        [(jz_rot(jnp.array(yaw, jnp.float32)), jnp.array(t, jnp.float32))
         for t, yaw in POSES])
    robot = MultiRobot.create(
        [RobotPanda.create(device="cpu") for _ in POSES],
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
          torch.tensor(t, dtype=torch.float32)) for t, yaw in POSES])
    return (JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=0.02),
            PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                         obstacle_cutoff_margin=0.02))


def test_warps_walk_the_block_pairs(tasks):
    """15 block pairs on 10 warps (320 threads): warp w takes block pairs
    w and w + 10, each block pair once; the value phase's 10 row ranges
    cover the rows in order within BALANCE of their mean operation count;
    the block fits the card's shared memory."""
    _, ptask = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    lay = terms.plain.layout
    ints, floats = pack_multirobot_params(lay)
    a = mr_sections(ints, floats)
    launch = mr_terms_launch_config(ints, len(floats))
    assert launch == terms.params[4] and a["scratch"] == 0
    W = launch["warps"]
    assert (a["n_bp"], W, launch["threads"]) == (15, 10, 320)
    assert launch["smem_bytes"] <= SMEM_MAX
    walked = sorted(b for w in range(W) for b in range(w, a["n_bp"], W))
    assert walked == list(range(a["n_bp"]))
    cuts = a["vcuts"]
    n_rows = 2 * a["NO"] + a["K"]
    assert len(cuts) == W + 1 and cuts[0] == 0 and cuts[-1] == n_rows
    assert (np.diff(cuts) >= 0).all()
    ops = cost_row_ops(lay)
    per = np.array([ops[c0:c1].sum() for c0, c1 in zip(cuts, cuts[1:])])
    assert per.max() <= BALANCE * per.mean()


def test_rows_match_jax(tasks):
    jtask, ptask = tasks
    q = rand_q(ptask.robot, 8, seed=50, lo=0.2, hi=0.8).T
    r, J = ptask.collision_residuals.residuals_and_jacobian(
        torch.as_tensor(q))
    jr, jJ = jtask.collision_residuals.residuals_and_jacobian(jnp.asarray(q))
    assert r.shape == (8, 350) and bool((r > 0).any())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)


def test_terms_match_jax_in_the_solver_layout(tasks):
    jtask, ptask = tasks
    q = rand_q(ptask.robot, 8, seed=51, lo=0.3, hi=0.7)
    ref = jax_mr_terms_factory(jtask)(jnp.asarray(q), 50.0, h=4)
    got = ptask.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                         50.0, h=4)
    _close_terms(got, ref, "five pandas, h=4")


def test_kernel_models_give_the_plain_terms_and_cost(tasks):
    _, ptask = tasks
    res = ptask.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    lay = terms.plain.layout
    ints, floats = pack_multirobot_params(lay)
    q = rand_q(ptask.robot, 32, seed=52)
    got = model_mr_terms(ints, floats, q)
    ref = terms.plain.unscaled(torch.as_tensor(q).double())
    assert float(ref[2].max()) > 0
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-7 * float(np.abs(r).max()))
    # the float32 order: only the active rows add, as the kernel does
    active = model_mr_terms(ints, floats, q, np.float32)
    every = model_mr_terms(ints, floats, q, np.float32, every_row=True)
    for x, y in zip(active, every):
        np.testing.assert_array_equal(x, y)
    assert cost.params[3]["threads_per_lane"] == 8
    c = model_cost(*pack_cost_kernel_params(lay), q)
    ref_c = cost.plain(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(c, ref_c, rtol=2e-5,
                               atol=3e-5 * float(np.abs(ref_c).max()))


def test_ninth_member_is_refused_in_words():
    """Nine Pandas: each hook refuses in its kernel's words on a tensor off
    the CPU (a meta tensor standing in for a CUDA one), before any
    packing; the CPU takes the plain terms and cost."""
    robot = MultiRobot.create(
        [RobotPanda.create(device="cpu") for _ in range(9)],
        [(z_rot(torch.tensor(0.0)), torch.tensor([0.0, 0.8 * i, 0.0]))
         for i in range(9)])
    res = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                       obstacle_cutoff_margin=0.02).collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    assert terms.params[1] is None and cost.params[1] is None
    meta = torch.zeros((63, 2), device="meta")
    for hook, words in (
            (terms.unscaled, "the CUDA MultiRobot terms kernel takes at most "
                             "8 members"),
            (cost, "the CUDA cost kernel takes at most 8 members")):
        with pytest.raises(NotImplementedError, match=words):
            hook(meta)
    q = torch.zeros((63, 2))
    assert torch.equal(cost(q), cost.plain(q))
