"""A kinematic robot in a 2-D grid scene: the UR10 and the Panda in
EnvDense2D's fixed objects precomputed into a 0.01 m grid (the JAX
package's grid, carried across by convert.py), the port's plain terms and
cost against the JAX package's Pallas factories in interpret mode (their
grid split pipeline), and the kernels' CPU models (``model_terms``,
``model_cost``) on the packed buffers with the grid table against the
plain version.

Tolerance: the terms test's (atol 3e-5 * max|ref| plus rtol 2e-5).
Exclusion rule (tests/test_torch_grid_terms.py's): a lane whose object
point's (x, y) lies within 1e-4 of a cell width of a cell face may pick
the neighbouring cell in the other float32 order, and is not held; at
most one of the 16 lanes may be so."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.ops.pallas_terms import (
    collision_cost_pallas_factory, obstacle_terms_pallas_factory)
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.ops.lanes_fk import fk_lanes
from torch_robotics_tpu_torch.ops.terms_kernel import (
    pack_cost_kernel_params, pack_terms_params, scene_grid_table)

from test_torch_cost_schedule import model_cost
from test_torch_grasped_launch import model_terms
from test_torch_grid_sdf import grid_arrays
from test_torch_kin import export_jax_task
from test_torch_scene_2d import CUTOFF, LAM, N, hold, rand_q

CELL, FACE_TOL = 0.01, 1e-4
ROBOTS = {"ur10": JRobotUR10, "panda": JRobotPanda.create}


@pytest.fixture(scope="module", params=sorted(ROBOTS))
def case(request):
    """(name, the port's task in the JAX grid, q, JAX's K1 terms at LAM
    and its K8 cost, each run once in interpret mode)."""
    robot = ROBOTS[request.param]()
    jenv = JEnvDense2D(precompute_sdf_obj_fixed=True, sdf_cell_size=CELL)
    jtask = JPlanningTask(env=jenv, robot=robot,
                          obstacle_cutoff_margin=CUTOFF)
    q = rand_q(np.asarray(robot.q_min), np.asarray(robot.q_max), N, seed=8)
    terms = obstacle_terms_pallas_factory(jtask)(jnp.asarray(q), LAM,
                                                 interpret=True)
    cost = collision_cost_pallas_factory(jtask)(jnp.asarray(q),
                                                interpret=True)
    arrays = export_jax_task(JPlanningTask(env=JEnvDense2D(), robot=robot,
                                           obstacle_cutoff_margin=CUTOFF))
    arrays["objects"] = [{"grid": grid_arrays(jenv.grid_map_sdf_obj_fixed)}]
    task = task_from_numpy(arrays, device="cpu")
    return (request.param, task, q, [np.asarray(t) for t in terms],
            np.asarray(cost))


def near_face(task, q):
    """(N,) bool: a lane has an object point whose (x, y) lies within
    FACE_TOL cell widths of a face of the task's grid.  A point that does
    not move with q (the base link at x = y = 0, on a face in every lane)
    is computed exactly in both versions and is not counted."""
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    pts = lay.points(*fk_lanes(lay.model, torch.as_tensor(q)))
    x = pts[lay.obj_pos][:, :2].permute(0, 2, 1)             # (P, N, 2)
    moving = (x.amax(1) != x.amin(1)).any(-1)
    return task.df_obj_list[0].near_face(x[moving], FACE_TOL).any(0).numpy()


def test_grid_terms_and_cost_match_jax_kernels_in_interpret_mode(case):
    name, task, q, ref, ref_cost = case
    keep = ~near_face(task, q)
    assert keep.sum() >= N - 1, name
    res = task.collision_residuals
    got = res.obstacle_terms_lanes(torch.as_tensor(q), LAM)
    hold([g[..., keep] for g in got], [r[..., keep] for r in ref], name)
    hold([res.collision_cost_lanes(torch.as_tensor(q))[keep]],
         [ref_cost[keep]], name + " cost")


def test_kernel_models_on_the_2d_grid_buffers_match_plain(case):
    """terms.cu's float64 model and cost.cu's float32 model, on the 2-D grid
    task's packed buffers and its grid table, give its plain terms and
    cost off the lanes near a cell face."""
    name, task, _, _, _ = case
    m = task.robot.model
    q = rand_q(m.q_lower, m.q_upper, 256, seed=9)
    plain = task.collision_residuals.obstacle_terms_lanes.plain
    ref = plain.unscaled(torch.as_tensor(q))
    lay = plain.layout
    table = scene_grid_table(lay.df_obj_list).numpy()
    keep = ~near_face(task, q)
    assert keep.sum() >= 250, name
    got = model_terms(*pack_terms_params(lay), q, grid=table)
    hold([g[..., keep] for g in got], [r[..., keep] for r in ref],
         name + " terms")
    cost = model_cost(*pack_cost_kernel_params(lay), q, grid=table)
    hold([cost[keep]], [ref[2][keep]], name + " cost")
