"""The port's point mass in the 2-D dense scene (config 2's task) vs the
JAX package on the same numpy inputs: the plain lanes GN terms (the
point mass has no fused kernel in either package), the collision checks
and the trajectory masks, the task's wiring and its numpy round trip.

Terms tolerance as tests/test_torch_terms.py: atol 3e-5 * max|ref| plus
rtol 2e-5, float32 sums in another order.  The q draw avoids exact SDF
ties (measure-zero, where subgradients may split differently) but puts
points within a few millimetres of the rounded boxes' corners, where the
gradient switches between the face and the rounded corner."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_arrays, task_from_numpy
from torch_robotics_tpu_torch.envs import EnvDense2D
from torch_robotics_tpu_torch.ops import terms_kernel
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.tasks import PlanningTask

CUTOFF = 0.02


@pytest.fixture(scope="module")
def tasks():
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=CUTOFF)
    ptask = PlanningTask(env=EnvDense2D(device="cpu"),
                         robot=RobotPointMass.create(device="cpu"),
                         obstacle_cutoff_margin=CUTOFF)
    return jtask, ptask


def _corner_points(ptask, rng):
    """Points within 4 mm of every rounded box's corners, on both sides of
    the rounded arc, and just inside the faces next to them."""
    pts = []
    for obj in ptask.df_obj_list:
        for f in obj.fields:
            if type(f).__name__ != "RoundedBoxes":
                continue
            c, h = f.centers.numpy(), f.half_sizes.numpy()
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    corner = c + np.asarray([sx, sy]) * h
                    jitter = rng.uniform(-0.004, 0.004, size=(len(c), 4, 2))
                    pts.append(corner[:, None, :] + jitter)
    return np.concatenate([p.reshape(-1, 2) for p in pts])


def _q(ptask, n_random=300, seed=0):
    """q (2, N): uniform over 1.1x the workspace (some outside it) plus the
    corner points."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.1, 1.1, size=(n_random, 2))
    return np.ascontiguousarray(np.concatenate(
        [q, _corner_points(ptask, rng)]).T.astype(np.float32))


@pytest.mark.parametrize("h", [None, 4])
def test_point_mass_terms_match_jax(tasks, h):
    jtask, ptask = tasks
    q = _q(ptask)
    if h is not None:
        q = q[:, :h * (q.shape[1] // h)]
    lam = 1.0 / 1e-3 ** 2
    ref = jtask.collision_residuals.obstacle_terms_lanes(jnp.asarray(q), lam,
                                                         h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                         lam, h=h)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=3e-5 * float(np.abs(r).max()),
                                   rtol=2e-5)


def test_draw_reaches_the_corner_arcs_and_the_workspace(tasks):
    """Active SDF rows near the corners on the arc side (a gradient with
    two nonzero components) and active workspace rows."""
    _, ptask = tasks
    q = torch.as_tensor(_q(ptask))
    r, Jr = ptask.collision_residuals.obstacle_terms_lanes.rows(q)
    assert r.shape == (2, q.shape[1]) and Jr.shape == (2, 2, q.shape[1])
    sdf_active = r[0] > 0
    diagonal = (Jr[0].abs() > 1e-3).all(0)
    assert bool((sdf_active & diagonal).any())
    assert bool((r[1] > 0).any())


def test_collision_checks_match_jax(tasks):
    """compute_collision per waypoint and trajs_collision_masks per
    trajectory, equal flags (draws away from a margin's exact boundary)."""
    jtask, ptask = tasks
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.05, 1.05, size=(64, 4)).astype(np.float32)
    for margin in (None, 0.0):
        got = ptask.compute_collision(torch.as_tensor(x), margin=margin)
        ref = jtask.compute_collision(jnp.asarray(x), margin=margin)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    trajs = np.cumsum(rng.normal(scale=0.05, size=(32, 16, 4)), axis=1)
    trajs = (trajs + rng.uniform(-0.8, 0.8, size=(32, 1, 4))).astype(
        np.float32)
    got, got_w = ptask.trajs_collision_masks(torch.as_tensor(trajs))
    ref, ref_w = jtask.trajs_collision_masks(jnp.asarray(trajs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    assert 0 < int(got.sum()) < 32
    assert ptask.compute_fraction_free_trajs(torch.as_tensor(trajs)) == \
        pytest.approx(float(jtask.compute_fraction_free_trajs(
            jnp.asarray(trajs))))


def test_point_mass_has_no_fused_kernel(tasks):
    """As in the JAX package: the fused factories return None, the task
    takes the plain lanes terms and has no value-only lanes cost."""
    _, ptask = tasks
    assert terms_kernel.obstacle_terms_kernel_factory(ptask) is None
    assert terms_kernel.collision_cost_kernel_factory(ptask) is None
    res = ptask.collision_residuals
    assert res.collision_cost_lanes is None
    assert not hasattr(res.obstacle_terms_lanes, "plain")
    q = torch.as_tensor(_q(ptask, n_random=8)[:, :8])
    r, J = res.residuals_and_jacobian(q.T)
    assert r.shape == (8, 2) and J.shape == (8, 2, 2)
    torch.testing.assert_close(res(q.T), r)


def test_robot_matches_jax():
    jr, pr = JRobotPointMass.create(), RobotPointMass.create(device="cpu")
    q = np.random.default_rng(2).uniform(-1, 1, size=(5, 3, 2)).astype(
        np.float32)
    pts, J = pr.fk_map_collision_with_jac(torch.as_tensor(q))
    jpts, jJ = jr.fk_map_collision_with_jac(jnp.asarray(q))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(J.numpy(), np.asarray(jJ))
    assert pr.ws_dim == jr.ws_dim == 2 and pr.q_dim == 2
    np.testing.assert_array_equal(pr.q_min.numpy(), np.asarray(jr.q_min))
    np.testing.assert_array_equal(pr.object_margins.numpy(),
                                  np.asarray(jr.object_margins))


def test_point_mass_task_round_trip(tasks):
    """task_arrays -> task_from_numpy rebuilds the same task (robot, scene
    objects, workspace, cutoff), and a scene named by env_name gives the
    same terms."""
    _, ptask = tasks
    arrays = task_arrays(ptask)
    assert arrays["robot"] == "point_mass"
    back = task_from_numpy(arrays, device="cpu")
    assert isinstance(back.robot, RobotPointMass)
    q = torch.as_tensor(_q(ptask, n_random=64))
    ref = ptask.collision_residuals.obstacle_terms_lanes(q, 1e4)
    for a, b in zip(back.collision_residuals.obstacle_terms_lanes(q, 1e4),
                    ref):
        assert torch.equal(a, b)
    named = {k: v for k, v in arrays.items() if k != "objects"}
    named["env_name"] = "EnvDense2D"
    by_name = task_from_numpy(named, device="cpu")
    for a, b in zip(by_name.collision_residuals.obstacle_terms_lanes(q, 1e4),
                    ref):
        assert torch.equal(a, b)
    torch.testing.assert_close(back.ws_limits, ptask.ws_limits)
