"""The grid branch of the CUDA terms and cost kernels on the launch side
(``ops/terms_kernel.py``), without a GPU: the scene's packed grid header
and table (``_pack_scene``, ``scene_grid_table``), the buffers of all
three kernels cut as their parse_layout cuts them, the cost kernel's
16-byte records, row cuts that count the grid's object rows, the grid
table's checks in the wrappers, and a numpy model of
``kin_scene.cuh::grid_sdf`` on the packed header held to the plain lookup
bit for bit (the same float32 operations in the same order)."""
import numpy as np
import pytest
import torch

from torch_robotics_tpu_torch.envs import EnvBase, EnvSpheres3D
from torch_robotics_tpu_torch.geom import GridSDF, precompute_sdf_grid
from torch_robotics_tpu_torch.geom.sdf import MultiSphereField, ObjectField
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout, _grid_sdf_lanes
from torch_robotics_tpu_torch.ops.terms_kernel import (
    _grid_ptr, _pack_scene, collision_cost_kernel_factory, cost_launch_config,
    cost_row_ops, mr_terms_launch_config, obstacle_terms_kernel_factory,
    pack_cost_params, pack_multirobot_params, pack_terms_params,
    scene_grid_table)
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask

from test_torch_cost_launch import POSES, multirobot

F32 = np.float32


@pytest.fixture(scope="module")
def scene():
    """[grid at 0.1 m, a posed sphere object, grid at 0.2 m over a shifted
    box]: two grids around an analytic object, in df_obj_list order."""
    env = EnvSpheres3D(device="cpu")
    g1 = precompute_sdf_grid(env.limits, 0.1, env.obj_fixed_list,
                             device="cpu")
    g2 = precompute_sdf_grid([[-0.7, -0.9, -0.2], [0.9, 0.7, 1.1]], 0.2,
                             env.obj_fixed_list, device="cpu")
    obj = ObjectField.create(
        [MultiSphereField([[0.4, 0.2, 0.5]], [0.15], device="cpu")],
        pos=[0.1, 0.0, 0.1], device="cpu")
    return [g1, obj, g2]


def _task(df_list, robot=None):
    env = EnvBase(name="grid_scene", limits=[[-1, -1, -1], [1, 1, 1]],
                  obj_fixed_list=df_list, device="cpu")
    return PlanningTask(env=env, robot=robot or RobotPanda.create(
        device="cpu"), obstacle_cutoff_margin=0.02)


def test_pack_scene_grid_header(scene):
    g1, _, g2 = scene
    (obj_begin, kinds, counts, offs, obj_grid, grid_i), (
        rot, pos, grid_f, prims) = _pack_scene(scene, 3)
    assert obj_grid == [0, -1, 1]
    assert obj_begin == [0, 0, 1, 1]         # grids hold no groups
    assert kinds == [0] and counts == [1]
    assert grid_i == [[0, 20, 20, 20], [g1.n_cells] + list(g2.cmap_dim)]
    assert g2.cmap_dim == (8, 8, 7)
    lim = g2.limits.numpy()
    np.testing.assert_array_equal(
        grid_f[1], np.concatenate([lim[0], [0], np.abs(lim[1] - lim[0]),
                                   [0]]).astype(F32))
    assert grid_f.shape == (2, 8)
    np.testing.assert_array_equal(rot[0], np.eye(3).reshape(9))
    assert prims.shape == (4,)
    table = scene_grid_table(scene)
    assert table.shape == (g1.n_cells + g2.n_cells, 4)
    assert torch.equal(table[:g1.n_cells], g1.table())
    assert torch.equal(table[g1.n_cells:], g2.table())
    # a scene of one grid lends the grid's own cached table
    assert scene_grid_table([g1]) is g1.table()
    assert scene_grid_table(scene[1:2]) is None


def test_pack_scene_refuses_2d_grids():
    """A 2-D grid in a 3-D workspace is refused (2-D scenes pack for a 2-D
    workspace: tests/test_torch_scene_2d.py)."""
    from torch_robotics_tpu_torch.envs import EnvDense2D
    env = EnvDense2D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.1,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="in a 3-D workspace"):
        _pack_scene(env.get_df_obj_list(), 3)


def _terms_sections(ints, floats):
    """terms.cu's parse_layout in numpy: the scene sections of the cost
    kernel's buffers, which the terms buffers are with each point's joint
    mask closing the ints."""
    P = int(ints[2])
    a = _cost_sections(ints[:-P], floats)
    o = a["objects_at"]
    objects = floats[o:o + 12 * a["NOBJ"]].reshape(-1, 12)
    a.update(obj_pos=objects[:, 9:].reshape(-1), prims=floats[:o])
    return a


def test_terms_buffers_carry_the_grids(scene):
    task = _task(scene)
    ints, floats = pack_terms_params(TermsLayout(task))
    a = _terms_sections(ints, floats)
    assert ints[5] == 3 and ints[11] == 2           # NOBJ, NGRID
    np.testing.assert_array_equal(a["obj_grid"], [0, -1, 1])
    np.testing.assert_array_equal(a["grid_i"][4:], [8000, 8, 8, 7])
    np.testing.assert_array_equal(a["obj_pos"][3:6],
                                  np.asarray([0.1, 0.0, 0.1], F32))
    np.testing.assert_array_equal(a["prims"],
                                  np.asarray([0.4, 0.2, 0.5, 0.15], F32))
    terms = obstacle_terms_kernel_factory(task)
    assert terms.grid.shape == (8000 + 448, 4)


def test_multirobot_buffers_carry_the_grids(scene):
    """The MultiRobot terms kernel reads the cost packing's scene: the grid
    is an object with no groups (obj_grid 0) and a header (its first row,
    its cmap_dim) closing the cost sections; the launch shape holds it."""
    task = _task(scene[:1], multirobot(POSES["config4"]))
    hook = task.collision_residuals.obstacle_terms_lanes
    ints, floats = pack_multirobot_params(hook.plain.layout)
    assert ints[5] == 1 and ints[11] == 1           # NOBJ, NGRID
    # the cost sections close with the scene's: group_off (1 object, no
    # groups), obj_grid, the grid's header; the terms' sections follow
    end = int(ints[13])
    np.testing.assert_array_equal(ints[end - 6:end], [0, 0, 0, 20, 20, 20])
    assert mr_terms_launch_config(ints, len(floats)) == hook.params[4]
    assert hook.grid is scene[0].table()


def _cost_sections(ints, floats):
    """cost.cu's parse_layout in numpy: header, scene and record offsets."""
    (n_mem, D, P, NO, K, NOBJ, NG, S, n_slots, T, n_prims,
     NGRID) = (int(v) for v in ints[:12])
    o = 16 + 8 * S + n_mem + 1 + P + NO + 2 * K + T + 1
    a = dict(NOBJ=NOBJ, NGRID=NGRID, NO=NO, K=K, T=T)
    a["cuts"] = ints[o - T - 1:o]
    for name, n in (("obj_group_begin", NOBJ + 1), ("group_kind", NG),
                    ("group_count", NG), ("group_off", NG),
                    ("obj_grid", NOBJ), ("grid_i", 4 * NGRID)):
        a[name], o = ints[o:o + n], o + n
    assert o == len(ints)
    f = n_prims
    a["objects_at"], f = f, f + 12 * NOBJ
    a["grid_f_at"], f = f, f + 8 * NGRID
    a["grid_f"] = floats[a["grid_f_at"]:f]
    a["step_f_at"], f = f, f + 20 * S
    f += 12 * n_mem + NO + K + 6
    assert f == len(floats)
    return a


@pytest.mark.parametrize("which", ["mixed", "grid_only"])
def test_cost_buffers_keep_16_byte_records(scene, which):
    df = scene if which == "mixed" else scene[:1]
    lay = TermsLayout(_task(df))
    ints, floats = pack_cost_params(lay)
    a = _cost_sections(ints, floats)
    assert a["NOBJ"] == len(df) and a["NGRID"] == (2 if which == "mixed"
                                                    else 1)
    for at in (a["objects_at"], a["grid_f_at"], a["step_f_at"]):
        assert at % 4 == 0
    np.testing.assert_array_equal(a["grid_f"][:8], np.concatenate(
        [[-1, -1, -1, 0], [2, 2, 2, 0]]).astype(F32))
    # every row goes to the lane's threads: the object rows are counted
    # for a grid-only scene too
    assert a["cuts"][0] == 0 and a["cuts"][-1] == 2 * a["NO"] + a["K"]
    ops = cost_row_ops(lay)
    assert len(ops) == 2 * a["NO"] + a["K"]
    per_obj = 22 * a["NGRID"] + (15 + 10 if which == "mixed" else 0) + 4
    assert list(ops[:a["NO"]]) == [per_obj] * a["NO"]
    launch = cost_launch_config(ints, len(floats))
    assert launch["smem_bytes"] <= 232448


def test_multirobot_cost_rows_count_the_grid(scene):
    """Config 4 in a grid-only scene: its 16 object SDF rows are in the
    cost kernel's cut rows, and the cut stays balanced."""
    task = _task(scene[:1], multirobot(POSES["config4"]))
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    ints, floats = pack_cost_params(lay)
    a = _cost_sections(ints, floats)
    assert a["NO"] == 16 and a["cuts"][-1] == 2 * 16 + a["K"]
    assert a["T"] > 1
    cost = collision_cost_kernel_factory(task)
    assert cost.grid is scene[0].table()


def grid_sdf_model(gi, gf, table, x):
    """kin_scene.cuh's grid_sdf in numpy float32 on the packed header:
    x (3, N) -> rows (N, 4)."""
    gf = np.asarray(gf, F32)            # as packed (pack_*_params: _f32)
    flat = np.zeros(x.shape[1], np.int64)
    for k in range(3):
        c = F32(gi[1 + k])
        v = np.floor((x[k] - gf[k]) / gf[4 + k] * c).astype(F32)
        v = np.minimum(np.maximum(v, F32(0)), c - F32(1))
        flat = flat * gi[1 + k] + v.astype(np.int64)
    return table[gi[0] + flat]


def test_kernel_lookup_model_matches_the_plain_lookup(scene):
    """Points in and outside both grids, and points moved onto cell faces
    and off them by an ulp: the model's row is the plain lookup's cell."""
    (_, _, _, _, obj_grid, grid_i), (_, _, grid_f, _) = _pack_scene(scene,
                                                                     3)
    table = scene_grid_table(scene).numpy()
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.3, 1.3, size=(3, 5000)).astype(F32)
    faces = np.round((x[:, :1000] + 1) / 0.1) * F32(0.1) - 1
    x[:, :1000] = faces.astype(F32)
    x[:, 1000:2000] = np.nextafter(x[:, :1000], F32(2))
    for o, g in enumerate(obj_grid):
        if g < 0:
            continue
        rows = grid_sdf_model(grid_i[g], grid_f[g], table, x)
        val, grad = _grid_sdf_lanes(scene[o], torch.as_tensor(x))
        np.testing.assert_array_equal(rows[:, 0], val.numpy())
        np.testing.assert_array_equal(rows[:, 1:].T, grad.numpy())


def test_grid_table_checks():
    q = torch.zeros((7, 5))
    good = torch.zeros((10, 4))
    assert _grid_ptr(None, q) is None
    assert _grid_ptr(good, q) == good.data_ptr()
    for bad in (torch.zeros((10, 3)),
                torch.zeros((10, 4), dtype=torch.float64),
                torch.zeros((4, 10)).T, torch.zeros((10, 4), device="meta")):
        with pytest.raises(ValueError, match="grid table"):
            _grid_ptr(bad, q)


def test_table_is_built_once_on_the_grids_device():
    env = EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.2,
                       device="cpu")
    grid = env.grid_map_sdf_obj_fixed
    assert isinstance(grid, GridSDF) and grid.n_cells == 1000
    t = grid.table()
    assert t.device == grid.device and t.data_ptr() % 16 == 0
    assert grid.table() is t
