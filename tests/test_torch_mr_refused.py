"""MultiRobot tasks that the CUDA MultiRobot kernels refused until they took
every member the reference plans for, on the CPU, against the JAX
package: five Pandas (past the four members K5 took) and two Pandas, the
first with the learned self-collision net (whose net neither package's
MultiRobot rows read; its own pair rows stay).  The port's task
constructs, takes its plain terms and cost on the CPU, packs both kernels'
parameters (no refusal), and a tensor neither on the CPU nor on a card (a
meta tensor) raises at both hooks before any launch: nothing falls back to
the plain version off the CPU.  Their residuals, (2, 350) and (4, 65) on
the same numpy q, their Jacobians and their GN terms match the JAX
package's.

A scene past the index of the terms kernels' picked primitive (a group
of 65,537 spheres) is refused in the same words by the single robot's
kernels (K1) and the MultiRobot's (K5), before any packing.

Tolerances: residuals and Jacobians atol 1e-5 (metres), as
tests/test_torch_multi_robot.py; the GN terms there's terms tolerance, atol
3e-5 * max|ref| plus rtol 2e-5 (float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multi_robot import _close_terms
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as jax_mr_terms_factory
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvBase, EnvSpheres3D
from torch_robotics_tpu_torch.geom.sdf import ObjectField, Spheres
from torch_robotics_tpu_torch.ops.terms_kernel import _scene_refusal
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask

# name -> (members' nets, base (x, y) and yaw of each, cutoff, waypoints,
# the MultiRobot terms kernel's block pairs and warps a block)
CASES = {
    "five_pandas": ((False,) * 5, [((0.0, 0.8 * i), 0.0) for i in range(5)],
                    0.02, 2, (15, 10)),
    "panda_with_net": ((True, False), [((0.0, 0.6), 0.0),
                                       ((0.0, -0.6), np.pi)],
                       0.03, 4, (3, 3)),
}


def _tasks(name):
    nets, poses, cutoff, _, _ = CASES[name]
    jrobot = JMultiRobot.create(
        [JRobotPanda.create(use_learned_self_collision=n) for n in nets],
        [(jz_rot(jnp.array(yaw, jnp.float32)), jnp.array([x, y, 0.0],
                                                          jnp.float32))
         for (x, y), yaw in poses])
    robot = MultiRobot.create(
        [RobotPanda.create(use_learned_self_collision=n, device="cpu")
         for n in nets],
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
          torch.tensor([x, y, 0.0])) for (x, y), yaw in poses])
    return (JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=cutoff),
            PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                         obstacle_cutoff_margin=cutoff))


@pytest.mark.parametrize("name", sorted(CASES))
def test_refused_task_matches_jax_on_the_cpu(name):
    jtask, task = _tasks(name)
    _, _, _, n_way, (n_bp, warps) = CASES[name]
    robot = task.robot
    lo, hi = robot.q_min.numpy(), robot.q_max.numpy()
    u = np.random.default_rng(3).uniform(0.3, 0.7, size=(n_way, len(lo)))
    q = (lo + u * (hi - lo)).astype(np.float32)

    res = task.collision_residuals
    r = res(torch.as_tensor(q))
    jr = np.asarray(jtask.collision_residuals(jnp.asarray(q)))
    assert tuple(r.shape) == jr.shape == {"five_pandas": (2, 350),
                                          "panda_with_net": (4, 65)}[name]
    np.testing.assert_allclose(r.numpy(), jr, atol=1e-5)
    r2, J = res.residuals_and_jacobian(torch.as_tensor(q))
    jr2, jJ = jtask.collision_residuals.residuals_and_jacobian(
        jnp.asarray(q))
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)

    # the GN terms and the cost: the plain versions on the CPU
    q_cols = np.ascontiguousarray(q.T)
    terms = res.obstacle_terms_lanes
    _close_terms(terms(torch.as_tensor(q_cols), 50.0, h=None),
                 jax_mr_terms_factory(jtask)(jnp.asarray(q_cols), 50.0,
                                             h=None), name)
    cost = res.collision_cost_lanes(torch.as_tensor(q_cols))
    np.testing.assert_allclose(cost.numpy(),
                               0.5 * np.sum(jr.astype(np.float64) ** 2, -1),
                               rtol=1e-5, atol=1e-6 * float(cost.max()))

    # both kernels take the task: no refusal, the packed launch shapes;
    # a tensor off the CPU goes to the kernel, which takes CUDA tensors
    assert terms.refusal is None and res.collision_cost_lanes.refusal is None
    launch = terms.params[4]
    assert (launch["block_pairs"], launch["warps"]) == (n_bp, warps)
    assert res.collision_cost_lanes.params[3]["threads_per_lane"] >= len(
        robot.robots)
    meta = torch.zeros((robot.q_dim, n_way), device="meta")
    for hook in (terms.unscaled, res.collision_cost_lanes):
        with pytest.raises(ValueError, match="CUDA tensors"):
            hook(meta)


def _sphere_scene(n):
    """One object of one group of n small spheres above the workspace."""
    centers = np.random.default_rng(5).uniform(-1.0, 1.0, (n, 3)) + [0, 0, 4]
    return [ObjectField.create(
        [Spheres(torch.as_tensor(centers, dtype=torch.float32),
                 torch.full((n,), 0.01))], device="cpu")]


@pytest.mark.parametrize("members", [1, 2])
def test_scene_past_the_pick_index_is_refused(members):
    """A group of 65,537 spheres passes the picked primitive's index
    (cost.cuh: scene_sdf_pick, group << 16 | index): a single Panda's task
    (K1) and two Pandas' (K5) construct on the CPU and refuse a tensor off
    the CPU in the same words at the terms and the cost hook; 65,536
    spheres are within it."""
    words = "at most 65,536 primitives"
    assert _scene_refusal(_sphere_scene(1 << 16), 3) is None
    env = EnvBase(limits=[[-1.0] * 3, [1.0] * 3],
                  obj_fixed_list=_sphere_scene((1 << 16) + 1), device="cpu")
    pandas = [RobotPanda.create(device="cpu") for _ in range(members)]
    robot = pandas[0] if members == 1 else MultiRobot.create(
        pandas, [(z_rot(torch.tensor(0.0)), torch.tensor([0.0, y, 0.0]))
                 for y in (0.6, -0.6)])
    res = PlanningTask(env=env, robot=robot).collision_residuals
    assert words in res.obstacle_terms_lanes.refusal
    meta = torch.zeros((robot.q_dim, 3), device="meta")
    for hook in (res.obstacle_terms_lanes.unscaled, res.collision_cost_lanes):
        with pytest.raises(NotImplementedError, match=words):
            hook(meta)
