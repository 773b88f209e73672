"""Config 4 with its first Panda carrying the learned self-collision net
(``use_learned_self_collision=True``), on the CPU, against the JAX package.

The reference's fused MultiRobot factories decline a member with a net,
so it runs its XLA MultiRobot terms, which read no member's net and keep
the member's own pair rows (``MultiRobot.create`` takes them from the
member's ``self_pair_idxs``); its task then has no value-only cost hook,
and sGPMP scores such a task with 0.5 sum r^2 of its collision residuals.
The port's MultiRobot kernels take the member on the same rows: its
residuals, Jacobians and GN terms match the JAX package's (config 4's 143
rows; the net member's 10 own pairs on its diagonal block), its cost hook
0.5 sum r^2 of the JAX residuals, and float models of K5 and K8 reading
only their packed buffers (``model_mr_terms``, ``model_cost``) give the
plain terms and cost.

Tolerances: residuals and Jacobians atol 1e-5 (metres), GN terms atol
3e-5 * max|ref| plus rtol 2e-5, as tests/test_torch_multi_robot.py; the
cost 1e-5 relative; the K5 model 1e-7 of max|ref| in float64 (the
packing holds each margin + cutoff rounded to float32, the structured
plain version adds them in q's dtype); the K8 model (float32, the
kernel's order) at the terms tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cost_schedule import model_cost
from test_torch_multi_robot import (CONFIG4, _close_terms, model_mr_terms,
                                    mr_sections, rand_q)
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.ops.terms_kernel import (
    pack_cost_kernel_params, pack_multirobot_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda, RobotUR10
from torch_robotics_tpu_torch.tasks import PlanningTask


@pytest.fixture(scope="module")
def tasks():
    """(JAX task, port task) of config 4 with the first Panda's net."""
    jmake = {"panda": JRobotPanda.create, "ur10": JRobotUR10}
    make = {"panda": lambda **k: RobotPanda.create(device="cpu", **k),
            "ur10": lambda **k: RobotUR10(device="cpu")}
    net = [{"use_learned_self_collision": True}, {}, {}]
    jrobot = JMultiRobot.create(
        [jmake[k](**kw) for (k, _, _), kw in zip(CONFIG4, net)],
        [(jz_rot(jnp.array(yaw, jnp.float32)),
          jnp.array([x, y, 0.0], jnp.float32)) for _, (x, y), yaw in CONFIG4])
    robot = MultiRobot.create(
        [make[k](**kw) for (k, _, _), kw in zip(CONFIG4, net)],
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
          torch.tensor([x, y, 0.0])) for _, (x, y), yaw in CONFIG4])
    return (JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=0.02),
            PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                         obstacle_cutoff_margin=0.02))


def test_the_member_keeps_its_pairs_and_no_hook_refuses(tasks):
    """The net member's 10 own pairs are in the MultiRobot's pair list and
    on its diagonal block; neither the JAX task nor the port's rows read a
    net (the JAX task has no value-only cost hook: its fused cost factory
    declines the member); the port's hooks take the task."""
    jtask, ptask = tasks
    assert ptask.robot.robots[0].self_collision_net is not None
    assert getattr(jtask.collision_residuals, "collision_cost_lanes",
                   None) is None
    res = ptask.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    assert terms.refusal is None and cost.refusal is None
    lay = terms.plain.layout
    assert lay.net is None and [len(p) for p in lay.own_pairs] == [10, 10, 6]
    a = mr_sections(*pack_multirobot_params(lay))
    own = [int(e) >> 3 for e in a["entries"][a["bp_begin"][0]:
                                             a["bp_begin"][1]]
           if not int(e) & 4 and int(e) >> 3 >= 2 * a["NO"]]
    assert own == list(range(2 * a["NO"], 2 * a["NO"] + 10))


def test_rows_and_cost_match_jax(tasks):
    jtask, ptask = tasks
    q = rand_q(ptask.robot, 24, seed=31, lo=0.1, hi=0.9).T
    res = ptask.collision_residuals
    r, J = res.residuals_and_jacobian(torch.as_tensor(q))
    jr, jJ = jtask.collision_residuals.residuals_and_jacobian(jnp.asarray(q))
    assert r.shape == (24, 143) and bool((r > 0).any())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)
    # what the reference's sGPMP scores without a cost hook
    jr_v = np.asarray(jtask.collision_residuals(jnp.asarray(q)), np.float64)
    cost = res.collision_cost_lanes(torch.as_tensor(q).T.contiguous())
    np.testing.assert_allclose(cost.numpy(), 0.5 * np.sum(jr_v ** 2, -1),
                               rtol=1e-5, atol=1e-6 * float(cost.max()))


@pytest.mark.parametrize("h", [None, 4])
def test_terms_match_jax(tasks, h):
    """The port's plain terms against the terms the JAX task plans with
    (its XLA MultiRobot terms: obstacle_terms_lanes_factory)."""
    jtask, ptask = tasks
    q = rand_q(ptask.robot, 16, seed=32, lo=0.2, hi=0.8)
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 50.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                         50.0, h=h)
    _close_terms(got, ref, "net member, h=%s" % h)


def test_kernel_models_give_the_plain_terms_and_cost(tasks):
    """K5's float64 model and K8's float32 model, each on its packed
    buffers alone, against the plain terms and cost."""
    _, ptask = tasks
    res = ptask.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    lay = terms.plain.layout
    q = rand_q(ptask.robot, 32, seed=33)
    got = model_mr_terms(*pack_multirobot_params(lay), q)
    ref = terms.plain.unscaled(torch.as_tensor(q).double())
    assert float(ref[2].max()) > 0
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-7 * float(np.abs(r).max()))
    c = model_cost(*pack_cost_kernel_params(lay), q)
    ref_c = cost.plain(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(c, ref_c, rtol=2e-5,
                               atol=3e-5 * float(np.abs(ref_c).max()))
