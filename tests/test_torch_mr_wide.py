"""A MultiRobot with a member past eight joints, on the CPU, against the
JAX package: the 14-joint dual-arm TIAGo (``tasks/zoo_tasks.py``, built
the same way in both packages) and a Panda in EnvSpheres3D at cutoff 0.02,
d = 21 (chip_smoke.py's phase ``mr_wide``; the bases, the TIAGo 0.6 m
below the workspace's centre turned a quarter turn and the Panda 0.5 m
along its arms turned back, leave ~2% of uniform q free).

The CUDA MultiRobot terms kernel takes such a member on its route with its
sums in shared memory (``mr_terms_kernel<16>``): the launch shape carries the
widest member's joints and each warp's scratch, whose addressing (a
diagonal block's g and packed triangle, a cross block's d_i x d_j) a
model of the kernel's index arithmetic checks; residuals, Jacobians and GN terms
match the JAX package's, and float models of K5 and K8 reading only their
packed buffers give the plain terms and cost.  A member of 33 joints (a
point's joint mask is 32 bits) is refused in words on a tensor off the
CPU, while the cost kernel, on its own limits, takes the task.

Tolerances: residuals and Jacobians atol 1e-5 (metres), GN terms atol
3e-5 * max|ref| plus rtol 2e-5 (tests/test_torch_multi_robot.py); the K5
model 1e-7 of max|ref| in float64 (float32 margins in the packing); the
K8 model (float32) at the terms tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cost_schedule import model_cost
from test_torch_multi_robot import (_close_terms, model_mr_terms,
                                    mr_sections, rand_q)
from test_torch_tiago import _jax_tiago
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.kin import KinematicModel
from torch_robotics_tpu_torch.kin.urdf import UrdfJoint, UrdfLink, UrdfRobot
from torch_robotics_tpu_torch.ops.terms_kernel import (
    mr_terms_launch_config, pack_cost_kernel_params, pack_multirobot_params)
from torch_robotics_tpu_torch.robots import (KinematicRobot, MultiRobot,
                                             RobotPanda)
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.tasks import zoo_tasks as zt

SMEM_MAX = 232448
# (x, y, z) and yaw of the TIAGo's and the Panda's bases (chip_smoke.py
# MR_CELLS["mr_wide"])
POSES = (((0.0, 0.0, -0.6), np.pi / 2), ((0.5, 0.0, 0.0), np.pi))


@pytest.fixture(scope="module")
def tasks():
    jrobot = JMultiRobot.create(
        [_jax_tiago(), JRobotPanda.create()],
        [(jz_rot(jnp.array(yaw, jnp.float32)), jnp.array(t, jnp.float32))
         for t, yaw in POSES])
    robot = MultiRobot.create(
        [zt.tiago_dual_robot(device="cpu"), RobotPanda.create(device="cpu")],
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)), torch.tensor(t))
         for t, yaw in POSES])
    return (JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=0.02),
            PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                         obstacle_cutoff_margin=0.02))


def test_launch_shape_takes_the_wide_route(tasks):
    """d = 21, 147 rows; three block pairs, a warp each; the widest
    member's 14 joints pick mr_terms_kernel<16>; each warp's scratch is
    the TIAGo's diagonal block, g and packed triangle (14 + 105 floats a
    lane, beside the cross block's 98 and the Panda's 35), within the
    block's shared memory."""
    _, ptask = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    assert terms.refusal is None
    ints, floats = pack_multirobot_params(terms.plain.layout)
    a = mr_sections(ints, floats)
    launch = mr_terms_launch_config(ints, len(floats))
    assert launch == terms.params[4]
    assert (a["D"], 2 * a["NO"] + a["K"]) == (21, 147)
    assert (launch["member_dof"], launch["block_pairs"], launch["warps"],
            launch["threads"]) == (14, 3, 3, 96)
    assert a["scratch"] == 119 and len(a["vcuts"]) == launch["warps"] + 1
    n_rows = 2 * a["NO"] + a["K"]
    assert launch["smem_bytes"] == 4 * (
        -(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4 + 32 * (
            7 * a["D"] + 3 * a["P"] + 12 * a["n_slots"] + n_rows
            + a["n_bp"] + a["NO"] + launch["warps"] * a["scratch"]))
    assert launch["smem_bytes"] <= SMEM_MAX


def test_scratch_addressing_covers_each_block_once(tasks):
    """The wide route's scratch, as mr_terms.cu addresses it: a diagonal
    block's g_i entry c at c and its H entry (c1, c2), c1 <= c2 < d_i, at
    d_i + c1 d_i - c1 (c1 + 1) / 2 + c2, a cross block's entry (c1, c2) at
    c1 d_j + c2; each block's sums take every float of its first d_i (d_i
    + 3) / 2 or d_i d_j once, within the packed scratch."""
    _, ptask = tasks
    a = mr_sections(*pack_multirobot_params(
        ptask.collision_residuals.obstacle_terms_lanes.plain.layout))
    for i, j in zip(a["bp_i"], a["bp_j"]):
        di, dj = int(a["mem_D"][i]), int(a["mem_D"][j])
        if i == j:
            idx = list(range(di)) + [di + c1 * di - c1 * (c1 + 1) // 2 + c2
                                     for c1 in range(di)
                                     for c2 in range(c1, di)]
            n = di * (di + 3) // 2
        else:
            idx = [c1 * dj + c2 for c1 in range(di) for c2 in range(dj)]
            n = di * dj
        assert sorted(idx) == list(range(n)) and n <= a["scratch"]


def test_rows_match_jax(tasks):
    jtask, ptask = tasks
    q = rand_q(ptask.robot, 12, seed=41, lo=0.2, hi=0.8).T
    r, J = ptask.collision_residuals.residuals_and_jacobian(
        torch.as_tensor(q))
    jr, jJ = jtask.collision_residuals.residuals_and_jacobian(jnp.asarray(q))
    assert r.shape == (12, 147) and bool((r > 0).any())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)


@pytest.mark.parametrize("h", [None, 4])
def test_terms_match_jax(tasks, h):
    jtask, ptask = tasks
    q = rand_q(ptask.robot, 16, seed=42, lo=0.2, hi=0.8)
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 50.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                         50.0, h=h)
    _close_terms(got, ref, "tiago + panda, h=%s" % h)


def test_kernel_models_give_the_plain_terms_and_cost(tasks):
    """K5's float64 model and K8's float32 model (three threads a lane at
    d = 21: a thread stages at most 8 q), on their buffers alone."""
    _, ptask = tasks
    res = ptask.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    lay = terms.plain.layout
    q = rand_q(ptask.robot, 32, seed=43)
    got = model_mr_terms(*pack_multirobot_params(lay), q)
    ref = terms.plain.unscaled(torch.as_tensor(q).double())
    assert float(ref[2].max()) > 0
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-7 * float(np.abs(r).max()))
    assert cost.refusal is None and cost.params[3]["threads_per_lane"] == 3
    c = model_cost(*pack_cost_kernel_params(lay), q)
    ref_c = cost.plain(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(c, ref_c, rtol=2e-5,
                               atol=3e-5 * float(np.abs(ref_c).max()))


def _chain(n: int):
    """A chain of n revolute joints about z, 5 cm apart, its last three
    links' origins as collision points and one pair (chip_smoke.chain_task's
    robot)."""
    joints = [UrdfJoint(name="j%d" % i, type="revolute", parent="l%d" % i,
                        child="l%d" % (i + 1), origin_xyz=(0.05, 0.0, 0.0),
                        origin_rpy=(0.0, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
                        limit_lower=-2.0, limit_upper=2.0, has_limit=True)
              for i in range(n)]
    model = KinematicModel.from_urdf_robot(UrdfRobot(
        name="chain%d" % n, links=[UrdfLink(name="l%d" % i)
                                   for i in range(n + 1)], joints=joints),
        name="chain%d" % n, device="cpu")
    return KinematicRobot.create(
        model, object_coll_links=["l%d" % i for i in (n // 2, n - 1, n)],
        object_coll_margins=[0.05] * 3, self_coll_pairs={"l%d" % n: ["l0"]})


def test_33_joint_member_is_refused_in_words():
    """A member of 33 joints passes K5's 32 a member (a point's joint mask
    is 32 bits over its member's columns): the task constructs with its
    plain terms on the CPU and its terms hook raises the refusal on a
    tensor off the CPU; 32 joints are within the cap.  The cost kernel, on
    its own limits (40 joints, two members), takes both."""
    words = "the CUDA MultiRobot terms kernel takes at most 32 joints " \
            "per member"
    for n, refused in ((33, True), (32, False)):
        robot = MultiRobot.create(
            [_chain(n), RobotPanda.create(device="cpu")],
            [(z_rot(torch.tensor(0.0)), torch.tensor([0.0, 0.0, 0.0])),
             (z_rot(torch.tensor(0.0)), torch.tensor([0.0, 0.8, 0.0]))])
        res = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                           obstacle_cutoff_margin=0.02).collision_residuals
        terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
        assert cost.refusal is None
        meta = torch.zeros((robot.q_dim, 4), device="meta")
        if refused:
            assert terms.refusal == words
            with pytest.raises(NotImplementedError, match=words):
                terms.unscaled(meta)
        else:
            assert terms.refusal is None
            assert terms.params[4]["member_dof"] == 32
            with pytest.raises(ValueError, match="CUDA tensors"):
                terms.unscaled(meta)
        q = torch.zeros((robot.q_dim, 4))
        for a_, b_ in zip(terms.unscaled(q), terms.plain.unscaled(q)):
            assert torch.equal(a_, b_)
