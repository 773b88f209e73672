"""The port's GN obstacle terms (plain version of the CUDA terms kernel) vs
the JAX package's XLA lanes terms on the same numpy inputs.

The JAX side is ``obstacle_terms_lanes_factory``, which the fused Pallas
kernel is bit-identical to (ops/pallas_terms.py docstring); its interpret
mode costs minutes of CPU compile.  Tolerance as tests/test_pallas_terms.py
holds the kernel: atol 3e-5 * max|ref| plus rtol 2e-5 — float32 sums in
another order.  Scenes avoid exact SDF ties (measure-zero, where gradient
subgradients may split differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvBase as JEnvBase
from torch_robotics_tpu.envs import EnvMazeBoxes3D as JEnvMazeBoxes3D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.geom.sdf import MultiSharpBoxField as JSharpBoxes
from torch_robotics_tpu.geom.sdf import ObjectField as JObjectField
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.ops.lanes_fk import (TermsLayout,
                                                   fk_positions_lanes)
from torch_robotics_tpu_torch.ops.terms_kernel import pack_terms_params

from test_torch_kin import export_jax_task


def _sharp_scene():
    """Two rotated sharp boxes (no env in env_layouts.json has any) in a
    tight workspace, so object points leave it."""
    c, s = np.cos(0.3), np.sqrt(0.5) * np.sin(0.3)
    obj = JObjectField.create(
        [JSharpBoxes([[0.3, 0.1, 0.4], [-0.35, 0.2, 0.5]],
                     [[0.2, 0.3, 0.25], [0.15, 0.4, 0.2]])],
        pos=[0.05, -0.1, 0.1], ori=[c, s, 0.0, s])
    return JEnvBase(name="sharp", limits=[[-0.6, -0.6, -0.2],
                                          [0.6, 0.6, 0.9]],
                    obj_fixed_list=[obj])


SCENES = {
    "spheres3d": (JEnvSpheres3D, 0.05),
    "maze_boxes3d": (JEnvMazeBoxes3D, 0.3),
    "sharp_boxes_tight_ws": (_sharp_scene, 0.3),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def tasks(request):
    make_env, self_margin = SCENES[request.param]
    jtask = JPlanningTask(
        env=make_env(),
        robot=JRobotPanda.create(self_collision_margin_robot=self_margin),
        obstacle_cutoff_margin=0.03)
    return request.param, jtask, task_from_numpy(export_jax_task(jtask),
                                                 device="cpu")


def _rand_q(task, n, seed):
    """q (7, n) over 1.4x the joint range: some joints past their clamps."""
    rng = np.random.default_rng(seed)
    lo, hi = task.robot.model.q_lower, task.robot.model.q_upper
    u = rng.uniform(-0.2, 1.2, size=(lo.shape[0], n))
    return (lo[:, None] + u * (hi - lo)[:, None]).astype(np.float32)


@pytest.mark.parametrize("h", [None, 8])
def test_terms_match_jax(tasks, h):
    name, jtask, ptask = tasks
    q = _rand_q(ptask, 24, seed=5)
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 77.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(
        torch.as_tensor(q), 77.0, h=h)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=3e-5 * float(np.abs(r).max()),
                                   rtol=2e-5, err_msg=name)


def test_scenes_exercise_every_row_kind(tasks):
    """The q draw gives nonzero terms, puts object points outside the
    workspace (tight-workspace scene) and self pairs within their margin
    (the box scenes' wide margins)."""
    name, _, ptask = tasks
    q = torch.as_tensor(_rand_q(ptask, 24, seed=5))
    lay = TermsLayout(ptask)
    g = ptask.collision_residuals.obstacle_terms_lanes(q, 1.0)[0]
    assert float(g.abs().max()) > 0
    pts = fk_positions_lanes(ptask.robot.model, q.T)          # (N, L, 3)
    if name == "sharp_boxes_tight_ws":
        obj = pts[:, list(ptask.robot.object_coll_idxs)]
        assert bool(((obj < ptask.ws_min) | (obj > ptask.ws_max)).any())
    if name != "spheres3d":             # wide self-collision margins
        used = pts[:, lay.used_links]
        dist = (used[:, lay.pair_a] - used[:, lay.pair_b]).norm(dim=-1)
        assert bool((dist < ptask.robot.self_margins).any())


def test_cpu_tensors_take_the_plain_version(tasks):
    _, _, ptask = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    q = torch.as_tensor(_rand_q(ptask, 16, seed=6))
    for a, b in zip(terms(q, 3.0, h=4), terms.plain(q, 3.0, h=4)):
        assert torch.equal(a, b)


def test_residual_rows_are_zero_off_their_live_columns(tasks):
    """A row's Jacobian column is zero unless the row is active (r > 0),
    the joint moves the row's point (or a pair's either point) and q lies
    within the joint's clamp: the work count behind the terms kernel's
    bound in chip_smoke.py skips exactly these columns.  The rows also
    reassemble into the plain version's g, Hqq and cost."""
    _, _, ptask = tasks
    plain = ptask.collision_residuals.obstacle_terms_lanes.plain
    q = torch.as_tensor(_rand_q(ptask, 24, seed=7))
    r, Jr = plain.rows(q)
    a, b = TermsLayout(ptask).row_joints()
    model = ptask.robot.model
    ctrl = list(model.controlled_link_idxs())
    lo = torch.as_tensor(model.clamp_lower[ctrl])[:, None]
    hi = torch.as_tensor(model.clamp_upper[ctrl])[:, None]
    live = (torch.as_tensor(a | b)[:, :, None] & ((q >= lo) & (q <= hi))[None]
            & (r > 0)[:, None])
    assert Jr.shape == (len(a), 7, 24) and r.shape == (len(a), 24)
    assert bool((Jr[~live] == 0).all())
    assert bool((Jr[live] != 0).any())
    g, Hqq, cost = plain.unscaled(q)
    torch.testing.assert_close(g, torch.sum(r[:, None] * Jr, dim=0))
    torch.testing.assert_close(cost, 0.5 * torch.sum(r * r, dim=0))
    torch.testing.assert_close(
        Hqq, torch.sum(Jr[:, :, None] * Jr[:, None, :], dim=0))


def test_kernel_buffers_follow_the_layout(tasks):
    """Section lengths of the packed buffers match what terms.cu parses:
    the cost kernel's buffers of one member, then each point's joint
    mask."""
    _, _, ptask = tasks
    lay = TermsLayout(ptask)
    ints, floats = pack_terms_params(lay)
    (n_mem, D, P, NO, K, NOBJ, NG, S, n_slots, T, n_prims, NGRID,
     G) = (int(v) for v in ints[:13])
    assert (n_mem, D, P, NO, K, T, G) == (1, 7, len(lay.used_links),
                                          len(lay.obj_pos), len(lay.pair_a),
                                          1, 0)
    assert ints.size == (16 + 8 * S + n_mem + 1 + P + NO + 2 * K + T + 1
                         + NOBJ + 1 + 3 * NG + NOBJ + 4 * NGRID + P)
    anc = lay.model.ancestry_matrix()[lay.point_links]
    np.testing.assert_array_equal(ints[-P:], (anc * 1 << np.arange(D))
                                  .sum(1))
    # analytic scenes: every object's grid index is -1, no grid header
    groups = ints[:-P]
    assert NGRID == 0 and (groups[-NOBJ:] == -1).all()
    groups = groups[:-NOBJ]
    group_off, group_count = groups[-NG:], groups[-2 * NG:-NG]
    group_kind = groups[-3 * NG:-2 * NG]
    width = np.asarray([4, 7, 6, 4])[group_kind]
    # each group's table padded to whole 16-byte records
    sizes = -(-(group_count * width) // 4) * 4
    np.testing.assert_array_equal(group_off, np.cumsum(sizes) - sizes)
    assert n_prims == int(sizes.sum())
    assert floats.size == (n_prims + 12 * NOBJ + 8 * NGRID + 20 * S
                           + 12 * n_mem + NO + K + 6)


def test_scene_sdf_and_analytic_gradient_match_jax_autodiff(tasks):
    """Scene SDF values vs the JAX env, and the port's closed-form gradient
    vs jax.grad of the JAX scene SDF (an independent derivation), at
    random points (ties between primitives have probability zero)."""
    import jax
    from torch_robotics_tpu_torch.ops.lanes_fk import sdf_and_grad_lanes
    _, jtask, ptask = tasks
    rng = np.random.default_rng(8)
    x = rng.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)

    def j_sdf(p):
        s = None
        for obj in jtask.df_obj_list:
            v = obj.signed_distance(p)
            s = v if s is None else jnp.minimum(s, v)
        return s

    ref_v = np.asarray(jax.vmap(j_sdf)(jnp.asarray(x)))
    ref_g = np.asarray(jax.vmap(jax.grad(j_sdf))(jnp.asarray(x)))
    got_v = ptask.env.compute_sdf(torch.as_tensor(x)).numpy()
    v, g = sdf_and_grad_lanes(ptask.df_obj_list, torch.as_tensor(x.T))
    np.testing.assert_allclose(got_v, ref_v, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), ref_v, atol=1e-6)
    np.testing.assert_allclose(g.numpy().T, ref_g, atol=1e-5)
