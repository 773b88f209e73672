"""The port's value-only MultiRobot collision cost (plain version of the
CUDA kernel's MultiRobot branch, ``mr_terms.cu``'s value-only variant) vs
the JAX package's ``collision_cost_pallas_factory`` in interpret mode, on
the same numpy q.

Embodiments: the Panda + UR10 pair of tests/test_pallas_terms.py, the
config-4 three-arm robot, and config 4's arms at a tighter pose set (bases
0.5 m apart) where mutual rows are active.  Tolerance: that test's, atol
2e-5 * max|ref| plus rtol 2e-5 (float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multi_robot import (CONFIG4, TWO_ARM,
                                    export_jax_multirobot_task, jax_task,
                                    rand_q)
from torch_robotics_tpu.ops.pallas_terms import \
    collision_cost_pallas_factory as jax_cost_factory
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.ops.terms_kernel import (
    collision_cost_kernel_factory, cost_launch_config, pack_cost_params,
    pack_multirobot_params)

TIGHT = (("panda", (0.0, 0.5), 0.0), ("panda", (0.0, -0.5), np.pi),
         ("ur10", (-0.5, 0.0), 0.0))
EMBODIMENTS = {"two_arm": TWO_ARM, "config4": CONFIG4, "tight": TIGHT}


@pytest.mark.parametrize("name", sorted(EMBODIMENTS))
def test_multirobot_cost_matches_jax_kernel(name):
    jtask = jax_task(EMBODIMENTS[name])
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    cost = ptask.collision_residuals.collision_cost_lanes
    assert cost is not None and hasattr(cost, "plain")
    q = rand_q(ptask.robot, 64, seed=5)
    ref = np.asarray(jax_cost_factory(jtask)(jnp.asarray(q), interpret=True))
    got = cost(torch.as_tensor(q)).numpy()
    assert got.shape == (64,) and np.isfinite(got).all()
    assert (ref > 0).any()
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(),
                               rtol=2e-5)
    if name == "tight":
        # some mutual rows are active on this q, so their values count
        rows = ptask.collision_residuals.obstacle_terms_lanes.plain.rows(
            torch.as_tensor(q))[0]
        n_mut = sum(len(v) for v in ptask.collision_residuals
                    .obstacle_terms_lanes.plain.layout.groups.values())
        assert bool((rows[-n_mut:] > 0).any())


def test_multirobot_cost_factory_and_shared_memory():
    """The factory returns the MultiRobot branch for a MultiRobot task (the
    task's hook is it), and the value-only kernel's shared memory holds
    per lane its q, points, stored transforms and thread shares only,
    where the terms kernel's (which the cost kernel's packing opens) also
    holds the joint axes and origins, every row's value and each object
    row's minimizing primitive."""
    ptask = task_from_numpy(export_jax_multirobot_task(jax_task(CONFIG4)),
                            device="cpu")
    cost = collision_cost_kernel_factory(ptask)
    q = torch.as_tensor(rand_q(ptask.robot, 8, seed=6))
    assert torch.equal(cost(q), ptask.collision_residuals
                       .collision_cost_lanes(q))
    lay = ptask.collision_residuals.obstacle_terms_lanes.plain.layout
    c_ints, c_floats = pack_cost_params(lay)
    ints, floats = pack_multirobot_params(lay)
    np.testing.assert_array_equal(floats, c_floats)
    np.testing.assert_array_equal(ints[:len(c_ints)][16:], c_ints[16:])
    D, P, NO, K, n_slots, T = (int(c_ints[i]) for i in (1, 2, 3, 4, 8, 9))
    launch = cost_launch_config(c_ints, len(c_floats))
    fixed = 4 * (-(-len(c_ints) // 4) * 4 + -(-len(c_floats) // 4) * 4)
    assert launch["smem_bytes"] == fixed + 4 * launch["lanes"] * (
        D + 3 * P + 12 * n_slots + T)
    terms_launch = ptask.collision_residuals.obstacle_terms_lanes.params[4]
    fixed = 4 * (-(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4)
    assert terms_launch["smem_bytes"] == fixed + 4 * 32 * (
        7 * D + 3 * P + 12 * n_slots + 2 * NO + K + 6 + NO)
