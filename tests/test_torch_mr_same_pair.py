"""A MultiRobot whose pair list holds a mutual pair between two object
points of one member, on the CPU, against the JAX package: config 4's
three arms (Panda, Panda, UR10 at their base poses, EnvSpheres3D, cutoff
0.02) with one pair added between the first Panda's panda_link2 and
panda_hand points (object points 0 and 4) at the sum of their margins,
0.125 + 0.08.

Both packages' block-structured assemblies decline the pair (a ValueError
when strict; the same warning when a task is built) and take the generic
padded assembly: residuals, Jacobians and GN terms match the JAX
package's generic assembly, and the value-only cost hook its 0.5 sum r^2.
The CUDA kernel's packing lists the pair as an own pair of the first
Panda's diagonal block (it adds to H_00 alone), and a float64 model of the
kernel reading only the packed buffers (``model_mr_terms``) gives the
plain terms.

Tolerances: residuals and Jacobians atol 1e-5 (metres), the GN terms atol
3e-5 * max|ref| plus rtol 2e-5 (float32 sums in another order), as
tests/test_torch_multi_robot.py; the model 1e-9 of max|ref| in float64
(its rows in the kernel's block order, the plain version's in the
reference's row order)."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multi_robot import (CONFIG4, _close_terms,
                                    export_jax_multirobot_task, jax_task,
                                    model_mr_terms, mr_sections, rand_q)
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as jax_mr_terms_factory
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as port_mr_terms_factory
from torch_robotics_tpu_torch.ops.terms_kernel import (
    mr_terms_launch_config, pack_multirobot_params)

# the added pair: the first Panda's object points 0 and 4 (panda_link2,
# panda_hand) at the sum of their margins
PAIR, MARGIN = (0, 4), 0.205
WORDS = ("mutual pair (0, 4) indexes object points of the same member 0; "
         "encode same-member pairs via the member's self-collision section "
         "instead (falling back to the generic padded assembly)")


def _quiet(fn, *args):
    """fn(*args) -> (its result, the messages of the warnings it gave)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, [str(w.message) for w in caught]


@pytest.fixture(scope="module")
def tasks():
    """(JAX task, port task, the warnings each gave when built)."""
    base = jax_task(CONFIG4)
    robot = dataclasses.replace(
        base.robot, self_pair_idxs=tuple(base.robot.self_pair_idxs) + (PAIR,),
        self_margins=jnp.concatenate([base.robot.self_margins,
                                      jnp.float32([MARGIN])]))
    jtask, jwarn = _quiet(lambda: JPlanningTask(
        env=JEnvSpheres3D(), robot=robot, obstacle_cutoff_margin=0.02))
    ptask, pwarn = _quiet(task_from_numpy, export_jax_multirobot_task(jtask),
                          "cpu")
    return jtask, ptask, jwarn, pwarn


def _q(task, n, seed):
    """q (d, n): uniform in the joint limits, with the added pair's row
    active in some lanes (the pair is active on ~1.6% of uniform q)."""
    pool = rand_q(task.robot, 64 * n, seed)
    r = task.collision_residuals.obstacle_terms_lanes.plain.rows(
        torch.as_tensor(pool))[0]
    hit = np.flatnonzero(r[-1].numpy() > 0)
    assert len(hit) >= 2
    keep = np.concatenate([hit[:n // 4], np.arange(n - min(n // 4,
                                                           len(hit)))])
    return np.ascontiguousarray(pool[:, keep[:n]])


def test_both_packages_warn_and_take_the_generic_assembly(tasks):
    """Task construction warns in the same words in both packages; called
    strict, both structured assemblies raise ValueError; the port's task
    packs both kernels (no refusal) with the pair in ``same_member``."""
    jtask, ptask, jwarn, pwarn = tasks
    assert WORDS in jwarn and WORDS in pwarn
    with pytest.raises(ValueError, match="same member 0"):
        jax_mr_terms_factory(jtask)
    with pytest.raises(ValueError, match="same member 0"):
        port_mr_terms_factory(ptask)
    assert _quiet(jax_mr_terms_factory, jtask, False)[0] is None
    assert _quiet(port_mr_terms_factory, ptask, False)[0] is None
    res = ptask.collision_residuals
    terms = res.obstacle_terms_lanes
    k = len(ptask.robot.self_pair_idxs) - 1
    assert terms.plain.layout.same_member == [(k, 0, 4, 0)]
    assert terms.refusal is None and res.collision_cost_lanes.refusal is None


def test_rows_match_jax(tasks):
    """Residuals and Jacobians over the full layout in the reference's row
    order (the added pair's row last), with it active in some lanes."""
    jtask, ptask, _, _ = tasks
    q = _q(ptask, 32, seed=21).T
    res = ptask.collision_residuals
    r, J = res.residuals_and_jacobian(torch.as_tensor(q))
    jr, jJ = jtask.collision_residuals.residuals_and_jacobian(jnp.asarray(q))
    assert r.shape == (32, 144) and bool((r[:, -1] > 0).any())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)
    # the pair's Jacobian lies in the first Panda's columns alone
    assert float(J[:, -1, 7:].abs().max()) == 0.0
    cost = res.collision_cost_lanes(torch.as_tensor(q).T.contiguous())
    np.testing.assert_allclose(
        cost.numpy(), 0.5 * np.sum(np.asarray(jr, np.float64) ** 2, -1),
        rtol=1e-5, atol=1e-6 * float(cost.max()))


@pytest.mark.parametrize("h", [None, 4])
def test_terms_match_jax_generic_assembly(tasks, h):
    """The port's plain terms against the JAX package's generic padded
    assembly (its obstacle_terms_lanes_factory on this task)."""
    jtask, ptask, _, _ = tasks
    q = _q(ptask, 16, seed=22)
    jterms, jwarn = _quiet(jax_terms_factory, jtask)
    assert WORDS in jwarn
    ref = jterms(jnp.asarray(q), 50.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                         50.0, h=h)
    _close_terms(got, ref, "same-member pair, h=%s" % h)


def test_kernel_packing_puts_the_pair_on_its_diagonal_block(tasks):
    """The pair's row is listed once, as an own pair (flags 0) of the first
    Panda's diagonal block, on no cross block; the float64 model of the
    kernel on the packed buffers gives the plain (generic) terms; the
    launch shape is config 4's (6 block pairs, 6 warps)."""
    _, ptask, _, _ = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    ints, floats = pack_multirobot_params(terms.plain.layout)
    a = mr_sections(ints, floats)
    row = 2 * a["NO"] + a["K"] - 1
    where = [(w, int(e) & 7) for w in range(a["n_bp"])
             for e in a["entries"][a["bp_begin"][w]:a["bp_begin"][w + 1]]
             if int(e) >> 3 == row]
    assert where == [(0, 0)]
    launch = mr_terms_launch_config(ints, len(floats))
    assert launch == terms.params[4]
    assert (launch["block_pairs"], launch["warps"]) == (6, 6)
    q = _q(ptask, 24, seed=23)
    got = model_mr_terms(ints, floats, q)
    ref = terms.plain.unscaled(torch.as_tensor(q).double())
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-9 * float(np.abs(r).max()))
