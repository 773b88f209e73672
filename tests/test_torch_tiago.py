"""The 14-joint dual-arm TIAGo and the 24-joint Shadow hand through the
port's planning stack against the JAX package, on the CPU: their tasks
built the same way in both packages (``tasks/zoo_tasks.py``'s tables
handed to each package's ``KinematicRobot.create``), the plain GN terms
(the terms kernel's plain version past 8 joints, with the TIAGo's
left-right arm pairs) and the value-only cost, one MPC step in float64,
the terms kernel's launch shape past 8 joints, and the kernels' joint and
member caps: the terms kernel takes up to 32 joints, the cost kernel
refuses on its own limits.

The terms tolerance is the JAX package's lanes-terms parity
(tests/test_lanes_terms.py:77-81); float64 as tests/test_torch_mpc_float64.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvBase as JEnvBase
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.envs import EnvTableShelf as JEnvTableShelf
from torch_robotics_tpu.geom import ObjectField as JObjectField
from torch_robotics_tpu.geom import MultiSphereField as JMultiSphereField
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu.robots import KinematicRobot as JKinematicRobot
from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
from torch_robotics_tpu.solve.mpc import MPCState as JMPCState
from torch_robotics_tpu.solve.mpc import mpc_step as jax_mpc_step
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D, EnvTableShelf
from torch_robotics_tpu_torch.kin import KinematicModel
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
from torch_robotics_tpu_torch.ops.terms_kernel import (
    COST_MAX_DOF, MAX_DOF, _cost_block, _terms_block, cost_launch_config,
    pack_cost_kernel_params, pack_terms_params, terms_launch_config)
from torch_robotics_tpu_torch.robots import (KinematicRobot, MultiRobot,
                                             RobotPanda)
from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams, MPCState,
                                            mpc_step, straight_line_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.tasks import zoo_tasks as zt

TERMS_RTOL, TERMS_ATOL = 1e-4, 1e-5
N = 512
MPC_B, MPC_H = 4, 16
GP = dict(n_support_points=MPC_H, dt=0.04, opt_iters=2, sigma_start=1e-3,
          sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
          step_size=1.0)
TOL_F64 = 1e-7


def _jax_tiago(dtype=jnp.float32):
    links, margins = zt.tiago_sphere_margins()
    return JKinematicRobot.create(
        jzoo.tiago_dual_holo(), object_coll_links=links,
        object_coll_margins=margins, self_coll_pairs=zt.TIAGO_SELF_PAIRS,
        self_collision_margin=zt.TIAGO_SELF_MARGIN, link_name_ee=zt.TIAGO_EE,
        name="TiagoDualHolo", dtype=dtype)


def _jax_shadow():
    robot = JKinematicRobot.create(
        jzoo.shadow_hand(), object_coll_links=list(zt.SHADOW_OBJECT_LINKS),
        object_coll_margins=list(zt.SHADOW_OBJECT_MARGINS),
        self_coll_pairs=zt.SHADOW_SELF_PAIRS,
        self_collision_margin=zt.SHADOW_SELF_MARGIN, link_name_ee="thtip",
        name="ShadowHand")
    center, radius = zt.SHADOW_BALL
    env = JEnvBase(name="ShadowBall",
                   limits=jnp.asarray(zt.SHADOW_LIMITS, jnp.float32),
                   obj_fixed_list=[JObjectField.create(
                       [JMultiSphereField(jnp.asarray([center]),
                                          jnp.asarray([radius]))],
                       name="ball")])
    return JPlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.01)


@pytest.fixture(scope="module")
def tasks():
    """name -> (the port's task on the CPU, the JAX package's)."""
    return {
        "tiago": (zt.tiago_dual_task(EnvTableShelf(device="cpu"),
                                     device="cpu"),
                  JPlanningTask(env=JEnvTableShelf(), robot=_jax_tiago(),
                                obstacle_cutoff_margin=0.03)),
        "shadow": (zt.shadow_hand_task(device="cpu"), _jax_shadow()),
    }


def _q_cols(task, n, seed):
    """q (d, n) float32 numpy over 1.4x the joint range."""
    lo = task.robot.model.q_lower.astype(np.float64)
    hi = task.robot.model.q_upper.astype(np.float64)
    u = np.random.default_rng(seed).uniform(-0.2, 1.2, (n, lo.shape[0]))
    return np.ascontiguousarray((lo + u * (hi - lo)).T.astype(np.float32))


def test_tasks_are_built_alike(tasks):
    for name, (task, jtask) in tasks.items():
        r, jr = task.robot, jtask.robot
        assert r.model.n_dofs == {"tiago": 14, "shadow": 24}[name]
        assert r.object_coll_idxs == jr.object_coll_idxs
        assert r.self_coll_idxs == jr.self_coll_idxs
        assert r.self_pair_idxs == jr.self_pair_idxs
        np.testing.assert_array_equal(r.object_margins.numpy(),
                                      np.asarray(jr.object_margins))
        np.testing.assert_array_equal(r.self_margins.numpy(),
                                      np.asarray(jr.self_margins))
    tiago = tasks["tiago"][0].robot
    assert len(tiago.object_coll_idxs) == 13
    assert len(tiago.self_pair_idxs) == 36
    np.testing.assert_allclose(
        tiago.object_margins.numpy(),
        [0.14] + [0.08, 0.07, 0.06, 0.08, 0.07, 0.06] * 2)


def _tiago_plan_q(task, n_problems, seed=0):
    """The straight-line plans' q (d, N) between free start and goal
    draws (free_start_goal), H = 16."""
    start, goal = zt.free_start_goal(task, n_problems, seed)
    th = straight_line_trajs(torch.as_tensor(start), torch.as_tensor(goal),
                             16)[..., :14]
    return np.ascontiguousarray(th.permute(2, 1, 0).reshape(14, -1).numpy())


@pytest.mark.parametrize("name", ["tiago", "shadow"])
def test_plain_terms_match_jax(tasks, name):
    """g, Hqq and the cost of the plain terms (what the terms kernel is
    held to past 8 joints) against the JAX package's lanes terms, with
    object, workspace and pair rows active on these q."""
    task, jtask = tasks[name]
    q = _q_cols(task, N, seed=3)
    terms = task.collision_residuals.obstacle_terms_lanes
    if name == "tiago":
        # the plans' q, and q where the arms come within a pair's margin
        # (rare in a uniform draw: 0.15% of the lanes)
        pool = _q_cols(task, 16384, seed=4)
        crossed = (terms.plain.rows(torch.as_tensor(pool))[0][26:] > 0).any(0)
        q = np.concatenate([q[:, :N // 4], _tiago_plan_q(task, 16)[
            :, :N // 2], pool[:, crossed.numpy()][:, :N // 4]], axis=1)
    rows = terms.plain.rows(torch.as_tensor(q))[0]
    lay = terms.plain.layout
    n_obj = len(lay.obj_pos)
    active = (rows > 0).numpy()
    assert active[:n_obj].any() and active[2 * n_obj:].any(), name
    lam = 1.0
    got = terms(torch.as_tensor(q), lam, h=None)
    ref = jtask.collision_residuals.obstacle_terms_lanes(jnp.asarray(q), lam,
                                                         h=None)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=TERMS_RTOL, atol=TERMS_ATOL)
    cost = task.collision_residuals.collision_cost_lanes
    jcost = jtask.collision_residuals.collision_cost_lanes
    np.testing.assert_allclose(cost(torch.as_tensor(q)).numpy(),
                               np.asarray(jcost(jnp.asarray(q))),
                               rtol=TERMS_RTOL, atol=TERMS_ATOL)
    assert torch.equal(cost(torch.as_tensor(q)), got[2])


def test_mpc_step_matches_jax_in_float64(tasks):
    """One MPC step (2 GN iterations, the main path's GPMP2Params) of the
    TIAGo from the straight-line plan, B = 4, H = 16, in float64."""
    task = tasks["tiago"][0]
    start, goal = zt.free_start_goal(task, MPC_B)
    theta0 = straight_line_trajs(torch.as_tensor(start),
                                 torch.as_tensor(goal), MPC_H).double()
    with jax.enable_x64(True):
        jtask = JPlanningTask(env=JEnvTableShelf(), robot=_jax_tiago(),
                              obstacle_cutoff_margin=0.03)
        j_state, _ = jax.jit(lambda st, g: jax_mpc_step(
            jtask.collision_residuals, st, g,
            JMPCParams(gpmp2=JGPMP2Params(**GP), iters_per_step=2)))(
                JMPCState(theta=jnp.asarray(theta0.numpy()),
                          x=jnp.asarray(start, jnp.float64)),
                jnp.asarray(goal, jnp.float64))
        j_theta = np.asarray(j_state.theta, np.float64)
    p_state, _ = mpc_step(
        task.collision_residuals,
        MPCState(theta=theta0, x=torch.as_tensor(start).double()),
        torch.as_tensor(goal).double(),
        MPCParams(gpmp2=GPMP2Params(**GP), iters_per_step=2))
    p_theta = p_state.theta.numpy()
    assert p_theta.shape == (MPC_B, MPC_H, 28) and np.isfinite(p_theta).all()
    assert np.abs(p_theta - theta0.numpy()).max() > 1e-3     # it moved
    np.testing.assert_allclose(p_theta, j_theta,
                               atol=TOL_F64 * np.abs(j_theta).max())


@pytest.mark.parametrize("name,d", [("tiago", 14), ("shadow", 24)])
def test_terms_launch_past_eight_joints(tasks, name, d):
    """The terms kernel's block past 8 joints counts Hqq's packed triangle
    in shared memory (232,448 bytes a block at most), and takes the lanes
    (of 128, 96, 64, 32) that keep the most warps resident on an SM: the
    SM's 233,472 bytes, 1 KB a block reserved, at most 8 warps of 255
    registers; the most lanes among equals."""
    task = tasks[name][0]
    lay = TermsLayout(task)
    ints, floats = pack_terms_params(lay)
    D, P, n_slots = int(ints[1]), int(ints[2]), int(ints[8])
    assert D == d
    per_lane = 4 * (7 * D + 3 * P + 12 * n_slots + D * (D + 1) // 2)
    fixed = 4 * (-(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4)

    def warps(lanes):
        smem = fixed + lanes * per_lane
        if smem > 232448:
            return 0
        return min(8, 233472 // (smem + 1024) * lanes // 32)
    launch = terms_launch_config(ints, len(floats))
    lanes = launch["lanes"]
    assert launch["smem_bytes"] == fixed + lanes * per_lane <= 232448
    assert all((warps(lanes), lanes) >= (warps(n), n)
               for n in (128, 96, 64, 32))
    assert warps(lanes) > warps(128)          # one block of 128 holds fewer
    for n in (32, 64):
        assert terms_launch_config(ints, len(floats), lanes=n)[
            "smem_bytes"] == fixed + n * per_lane
    hook = task.collision_residuals.obstacle_terms_lanes
    assert hook.refusal is None and hook.params[4] == launch
    # the cost kernel stages at most 8 q a thread: two threads a lane
    c_ints, c_floats = pack_cost_kernel_params(lay)
    c_launch = cost_launch_config(c_ints, len(c_floats))
    assert c_launch["threads_per_lane"] == -(-D // 8) == int(c_ints[9])
    assert task.collision_residuals.collision_cost_lanes.params[3] == c_launch


def _chain_urdf(path, n):
    """A chain of n revolute joints about z, 5 cm apart."""
    links = "".join('<link name="l%d"/>' % i for i in range(n + 1))
    joints = "".join(
        '<joint name="j%d" type="revolute"><parent link="l%d"/>'
        '<child link="l%d"/><origin xyz="0.05 0 0" rpy="0 0 0"/>'
        '<axis xyz="0 0 1"/><limit lower="-2" upper="2"/></joint>'
        % (i, i, i + 1) for i in range(n))
    path.write_text('<robot name="chain%d">%s%s</robot>' % (n, links, joints))
    return path


def _chain_task(tmp_path, n):
    model = KinematicModel.from_urdf(_chain_urdf(tmp_path / "c.urdf", n),
                                     device="cpu")
    assert model.name == "chain%d" % n and model.n_dofs == n
    links = ["l%d" % i for i in (n // 2, n - 1, n)]
    robot = KinematicRobot.create(model, object_coll_links=links,
                                  object_coll_margins=[0.02] * 3,
                                  self_coll_pairs={"l%d" % n: ["l0"]})
    return PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.01)


@pytest.mark.parametrize("n", [9, 31, 32, 33, 64, 65])
def test_joint_caps(tmp_path, n):
    """The terms kernel takes up to 32 joints (a point's joint mask is 32
    bits, bit 31 the int32's sign), the cost kernel up to 64 (8 q columns a
    thread, 8 threads a lane); past a cap the task keeps its plain hooks on
    the CPU and the hook raises on a tensor off the CPU (a meta tensor
    standing in for a CUDA one)."""
    task = _chain_task(tmp_path, n)
    res = task.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    q = torch.full((n, 3), 0.1)
    meta = torch.zeros((n, 3), device="meta")
    if n <= MAX_DOF:
        assert terms.refusal is None and terms.params[1] is not None
        masks = terms.params[1].numpy()[-terms.plain.layout.model.n_links:]
        tip = masks.view(np.uint32)[-1]
        assert tip == (1 << n) - 1 if n < 32 else tip == 0xFFFFFFFF
    else:
        assert terms.refusal == "the CUDA terms kernel takes at most 32 joints"
        with pytest.raises(NotImplementedError, match="at most 32 joints"):
            terms.unscaled(meta)
    if n <= COST_MAX_DOF:
        assert cost.refusal is None and cost.params[1] is not None
        assert cost.params[3]["threads_per_lane"] == -(-n // 8)
    else:
        assert cost.refusal == "the CUDA cost kernel takes at most 64 joints"
        with pytest.raises(NotImplementedError, match="at most 64 joints"):
            cost(meta)
    for a, b in zip(terms.unscaled(q), terms.plain.unscaled(q)):
        assert torch.equal(a, b)
    assert torch.equal(cost(q), cost.plain(q))


def _pandas(n):
    return MultiRobot.create(
        [RobotPanda.create(device="cpu") for _ in range(n)],
        [(z_rot(torch.tensor(0.0)), torch.tensor([0.0, 0.8 * i, 0.0]))
         for i in range(n)])


@pytest.mark.parametrize("n", [5, 9])
def test_cost_refusal_split(n):
    """A MultiRobot of five members is within both MultiRobot kernels'
    caps (8 members: K5's warps walk its 15 block pairs, K8 runs a thread
    a member); nine pass both, each refused in its own words (K8: phase 1
    runs one member's FK a thread, at most 8 threads a lane)."""
    task = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=_pandas(n),
                        obstacle_cutoff_margin=0.02)
    res = task.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    ints, floats = pack_cost_kernel_params(terms.plain.layout)
    launch, block_refusal = _cost_block(ints, len(floats))
    meta = torch.zeros((7 * n, 2), device="meta")
    if n == 5:
        assert terms.refusal is None and cost.refusal is None
        assert block_refusal is None and launch["threads_per_lane"] >= n
        with pytest.raises(ValueError, match="CUDA tensors"):
            cost(meta)
    else:
        assert terms.refusal == ("the CUDA MultiRobot terms kernel takes at "
                                 "most 8 members")
        assert cost.refusal == "the CUDA cost kernel takes at most 8 members"
        with pytest.raises(NotImplementedError, match=cost.refusal):
            cost(meta)
    q = torch.zeros((7 * n, 2))
    assert torch.equal(cost(q), cost.plain(q))


def test_register_route_block_has_no_triangle():
    """Below 9 joints the block is the register route's: no Hqq triangle
    in shared memory, 128 lanes (the Panda)."""
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(device="cpu"),
                        obstacle_cutoff_margin=0.03)
    ints, floats = pack_terms_params(TermsLayout(task))
    D, P, n_slots = int(ints[1]), int(ints[2]), int(ints[8])
    fixed = 4 * (-(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4)
    launch = _terms_block(ints, len(floats))[0]
    assert launch["lanes"] == 128
    assert launch["smem_bytes"] == fixed + 128 * 4 * (
        7 * D + 3 * P + 12 * n_slots)
