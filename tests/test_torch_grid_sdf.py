"""Precomputed SDF grids (geom/grid_sdf.py) vs the JAX package on the same
numpy inputs: the precompute in 2-D (EnvDense2D, 0.01 m cells) and 3-D
(EnvSpheres3D, 0.05 m), the nearest lookup and its surrogate gradient,
the trilinear lookup, the cell index's clamp, and the grid's carry-across
in convert.py.

Tolerances: the precompute's values 1e-6 (float32 SDFs of nodes whose
coordinates may differ by an ulp: jnp.linspace and torch.linspace round
differently); its gradients 1e-4 where JAX's is finite, except at nodes
where two primitives tie: JAX's vjp of a min averages the tied
gradients and the port takes the first, and an ulp in a node moves a near
tie either way, so at most 0.1% of the nodes are excluded, counted by a
gradient that differs.  Lookups of one grid at the same float32 points
are the same arithmetic in both packages and are held exactly; the
trilinear lookup to 1e-6 (another order of the corner sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.geom import GridSDF as JGridSDF
from torch_robotics_tpu_torch.convert import task_arrays, task_from_numpy
from torch_robotics_tpu_torch.envs import EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.geom import GridSDF, precompute_sdf_grid

from test_torch_kin import export_jax_task

SCENES = {"dense2d": (JEnvDense2D, EnvDense2D, 0.01),
          "spheres3d": (JEnvSpheres3D, EnvSpheres3D, 0.05)}
# share of nodes at a primitive tie whose gradient may differ
TIE_SHARE = 1e-3


def grid_arrays(jgrid) -> dict:
    """A JAX GridSDF as convert.py's ``grid`` entry (numpy)."""
    return {"limits": np.asarray(jgrid.limits),
            "sdf_grid": np.asarray(jgrid.sdf_grid),
            "grad_grid": np.asarray(jgrid.grad_grid),
            "cmap_dim": np.asarray(jgrid.cmap_dim)}


def port_grid(jgrid) -> GridSDF:
    """The port's GridSDF holding the JAX grid's own values."""
    a = grid_arrays(jgrid)
    return GridSDF.create(a["limits"], a["sdf_grid"], a["grad_grid"],
                          a["cmap_dim"], device="cpu")


@pytest.fixture(scope="module", params=sorted(SCENES))
def grids(request):
    jmake, make, cell = SCENES[request.param]
    jenv = jmake(precompute_sdf_obj_fixed=True, sdf_cell_size=cell)
    env = make(precompute_sdf_obj_fixed=True, sdf_cell_size=cell,
               device="cpu")
    return (request.param, jenv.grid_map_sdf_obj_fixed,
            env.grid_map_sdf_obj_fixed, env)


def _points(dim, n, seed, lo=-1.2, hi=1.2):
    """Points over 1.2x the [-1, 1] workspace (some outside the grid)."""
    return np.random.default_rng(seed).uniform(
        lo, hi, size=(n, dim)).astype(np.float32)


def test_precompute_matches_jax(grids):
    name, jgrid, grid, env = grids
    assert grid.cmap_dim == jgrid.cmap_dim
    assert grid.sdf_grid.shape == tuple(jgrid.cmap_dim)
    assert grid.grad_grid.shape == tuple(jgrid.cmap_dim) + (grid.dim,)
    np.testing.assert_array_equal(grid.limits.numpy(),
                                  np.asarray(jgrid.limits))
    np.testing.assert_allclose(grid.sdf_grid.numpy(),
                               np.asarray(jgrid.sdf_grid), atol=1e-6)
    ref = np.asarray(jgrid.grad_grid).reshape(-1, grid.dim)
    got = grid.grad_grid.numpy().reshape(-1, grid.dim)
    finite = np.isfinite(ref).all(-1)
    off = np.abs(got - ref).max(-1) > 1e-4
    assert int((finite & off).sum()) <= TIE_SHARE * finite.size, name
    # the precompute is the env's own and takes the fixed objects' place
    assert env.get_df_obj_list()[0] is grid
    assert grid.device == torch.device("cpu")


def test_nearest_lookup_and_cell_index_match_jax(grids):
    """The same grid and float32 points: the same cells, values and, by
    autograd, the cell's gradient as the derivative; points outside the
    limits clamp to the border cells."""
    _, jgrid, _, _ = grids
    grid = port_grid(jgrid)
    x = _points(grid.dim, 4096, seed=1)
    idx = grid._cell_index(torch.as_tensor(x))
    ref = jgrid._cell_index(jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    outside = (np.abs(x) > 1).any(-1)
    assert outside.any()
    assert bool((idx >= 0).all()) and bool(
        (idx < torch.as_tensor(grid.cmap_dim)).all())
    xt = torch.as_tensor(x).requires_grad_(True)
    val = grid.signed_distance(xt)
    ref = jgrid.signed_distance(jnp.asarray(x))
    np.testing.assert_array_equal(val.detach().numpy(), np.asarray(ref))
    (g,) = torch.autograd.grad(val.sum(), xt)
    jg = jax.vmap(jax.grad(jgrid.signed_distance))(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    flat = grid._flat_index(torch.as_tensor(x))
    np.testing.assert_array_equal(
        g.numpy(), grid.grad_grid.reshape(-1, grid.dim)[flat].numpy())
    for alias in (grid, grid.compute_signed_distance, grid.compute_cost):
        assert torch.equal(alias(torch.as_tensor(x)), val.detach())


def test_trilinear_lookup_matches_jax(grids):
    _, jgrid, _, _ = grids
    grid = port_grid(jgrid)
    x = _points(grid.dim, 2048, seed=2)
    np.testing.assert_allclose(
        grid.signed_distance_trilinear(torch.as_tensor(x)).numpy(),
        np.asarray(jgrid.signed_distance_trilinear(jnp.asarray(x))),
        atol=1e-6)


def test_float64_lookup_keeps_the_reference_index(grids):
    """A float64 query indexes in float64 (as JAX does under x64) and
    returns float64 values of the float32 grid."""
    _, jgrid, _, _ = grids
    grid = port_grid(jgrid)
    x = _points(grid.dim, 1024, seed=3).astype(np.float64)
    with jax.enable_x64(True):
        ref = np.asarray(JGridSDF(
            limits=jnp.asarray(np.asarray(jgrid.limits)),
            sdf_grid=jnp.asarray(np.asarray(jgrid.sdf_grid)),
            grad_grid=jnp.asarray(np.asarray(jgrid.grad_grid)),
            cmap_dim=jgrid.cmap_dim)._cell_index(jnp.asarray(x)))
    got = grid._cell_index(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert grid.signed_distance(torch.as_tensor(x)).dtype == torch.float64


def test_table_rows_are_the_cells(grids):
    """The kernels' (C, 4) table: row i = (sdf, grad, 0 pad) of flat cell
    i, float32, contiguous, built once."""
    _, _, grid, _ = grids
    t = grid.table()
    assert t is grid.table()
    assert t.shape == (grid.n_cells, 4) and t.dtype == torch.float32
    assert t.is_contiguous()
    assert torch.equal(t[:, 0], grid.sdf_grid.reshape(-1))
    assert torch.equal(t[:, 1:1 + grid.dim],
                       grid.grad_grid.reshape(-1, grid.dim))
    assert bool((t[:, 1 + grid.dim:] == 0).all())


def test_near_face_marks_points_by_cell_width(grids):
    _, _, grid, _ = grids
    dim = grid.dim
    extent = (grid.limits[1] - grid.limits[0]).numpy()
    cell = extent / np.asarray(grid.cmap_dim)
    # the center of cell 7 on every axis, then moved onto a face of it
    center = (grid.limits[0].numpy() + 7.5 * cell).astype(np.float32)
    on_face = center.copy()
    on_face[dim - 1] += np.float32(0.5 * cell[dim - 1])
    x = torch.as_tensor(np.stack([center, on_face]))
    assert grid.near_face(x).tolist() == [False, True]


def test_precompute_takes_a_chunk_and_explicit_device():
    env = EnvSpheres3D(device="cpu")
    a = precompute_sdf_grid(env.limits, 0.1, env.obj_fixed_list,
                            device="cpu")
    b = precompute_sdf_grid(env.limits.tolist(), 0.1, env.obj_fixed_list,
                            chunk=333, device="cpu")
    assert a.cmap_dim == b.cmap_dim == (20, 20, 20)
    assert torch.equal(a.sdf_grid, b.sdf_grid)
    assert torch.equal(a.grad_grid, b.grad_grid)


def test_convert_carries_the_grid_across():
    """A JAX task's grid as numpy -> the port's task -> numpy: the same
    arrays, in df_obj_list order before the analytic objects."""
    from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
    from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
    jenv = JEnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.1)
    jplain = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                           obstacle_cutoff_margin=0.02)
    arrays = export_jax_task(jplain)
    arrays["objects"] = [{"grid": grid_arrays(jenv.grid_map_sdf_obj_fixed)}
                         ] + arrays["objects"]
    task = task_from_numpy(arrays, device="cpu")
    assert isinstance(task.df_obj_list[0], GridSDF)
    assert len(task.df_obj_list) == 2
    back = task_arrays(task)
    for k, v in arrays["objects"][0]["grid"].items():
        np.testing.assert_array_equal(back["objects"][0]["grid"][k], v)
    assert back["objects"][1]["groups"][0]["kind"] == "spheres"


def test_grid_and_map_constructors_default_to_the_card(monkeypatch):
    """Without CUDA a default construction raises; nothing moves to the
    CPU unasked."""
    from torch_robotics_tpu_torch.geom import build_occupancy_map
    env = EnvSpheres3D(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: precompute_sdf_grid(env.limits, 0.5,
                                             env.obj_fixed_list),
                 lambda: GridSDF.create(np.zeros((2, 3)), np.zeros((2, 2, 2)),
                                        np.zeros((2, 2, 2, 3))),
                 lambda: build_occupancy_map(env.limits, 0.5,
                                             env.obj_fixed_list),
                 lambda: EnvSpheres3D(precompute_sdf_obj_fixed=True,
                                      sdf_cell_size=0.5)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
