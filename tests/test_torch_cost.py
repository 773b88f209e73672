"""The port's value-only collision cost (the plain version of the CUDA cost
kernel) vs the JAX package's Pallas cost kernel run in interpret mode, on
the same numpy inputs.

Tolerance as the terms kernel is held (tests/test_pallas_terms.py): atol
3e-5 * max|ref| plus rtol 2e-5 — float32 sums in another order (the Pallas
kernel interleaves each point's SDF and workspace rows; the port sums the
SDF rows first).  Random q in these scenes meets no exact SDF ties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvMazeBoxes3D as JEnvMazeBoxes3D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.pallas_terms import collision_cost_pallas_factory
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy

from test_torch_kin import export_jax_task
from test_torch_terms import _rand_q, _sharp_scene

ATOL_REL, RTOL = 3e-5, 2e-5
# (scene, self-collision margin, cutoff): the iLQR path's Panda in
# EnvSpheres3D at cutoff 0.06, and the terms tests' box scenes with wide
# self margins (active pair rows) and a tight workspace
SCENES = {
    "spheres3d_cutoff006": (JEnvSpheres3D, 0.05, 0.06),
    "maze_boxes3d": (JEnvMazeBoxes3D, 0.3, 0.03),
    "sharp_boxes_tight_ws": (_sharp_scene, 0.3, 0.03),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def tasks(request):
    make_env, self_margin, cutoff = SCENES[request.param]
    jtask = JPlanningTask(
        env=make_env(),
        robot=JRobotPanda.create(self_collision_margin_robot=self_margin),
        obstacle_cutoff_margin=cutoff)
    return request.param, jtask, task_from_numpy(export_jax_task(jtask),
                                                 device="cpu")


def test_cost_matches_jax_kernel_interpret(tasks):
    name, jtask, ptask = tasks
    q = _rand_q(ptask, 40, seed=11)
    ref = np.asarray(collision_cost_pallas_factory(jtask)(
        jnp.asarray(q), interpret=True))
    got = ptask.collision_residuals.collision_cost_lanes(torch.as_tensor(q))
    assert got.shape == ref.shape and float(np.abs(ref).max()) > 0, name
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=ATOL_REL * float(np.abs(ref).max()),
                               rtol=RTOL, err_msg=name)


def test_cost_is_half_the_squared_residuals(tasks):
    """The cost of each waypoint is 0.5 sum r^2 over the task's residual
    rows, and a CPU tensor takes the plain version bit for bit."""
    _, _, ptask = tasks
    res = ptask.collision_residuals
    q = torch.as_tensor(_rand_q(ptask, 24, seed=12))
    cost = res.collision_cost_lanes(q)
    assert torch.equal(cost, res.collision_cost_lanes.plain(q))
    r = res(q.T)                                          # (N, P)
    torch.testing.assert_close(cost, 0.5 * torch.sum(r * r, dim=-1),
                               rtol=1e-6, atol=1e-6 * float(cost.max()))
