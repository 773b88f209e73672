"""Occupancy maps (geom/occupancy.py) and the planning task's occupancy
collision check vs the JAX package on the same numpy inputs: EnvDense2D
at 0.01 m cells (the point mass) and EnvSpheres3D at 0.05 m (the Panda).

The maps are rasterized from each package's own analytic SDF at the cell
centers: a cell whose center lies within 1e-6 of a surface may fall on
either side (float32 SDFs in another op order), at most 0.1% of the
cells; every other cell, the lookups, the occupied points and the
distances are held exactly (distances to 1e-6: float32 norms)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.envs import EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.geom import OccupancyMap, build_occupancy_map
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.tasks import PlanningTask

SCENES = {"dense2d": (JEnvDense2D, EnvDense2D, 0.01),
          "spheres3d": (JEnvSpheres3D, EnvSpheres3D, 0.05)}
SURFACE_SHARE = 1e-3


@pytest.fixture(scope="module", params=sorted(SCENES))
def maps(request):
    jmake, make, cell = SCENES[request.param]
    jenv, env = jmake(), make(device="cpu")
    return (jenv, env, jenv.build_occupancy_map(cell_size=cell),
            env.build_occupancy_map(cell_size=cell))


def _same_map(jocc):
    """The port's OccupancyMap holding the JAX map's own cells."""
    return OccupancyMap(map=torch.as_tensor(np.array(jocc.map)),
                        cell_size=jocc.cell_size, cmap_dim=jocc.cmap_dim)


def test_build_occupancy_map_matches_jax(maps):
    jenv, env, jocc, occ = maps
    assert occ.cmap_dim == jocc.cmap_dim and occ.cell_size == jocc.cell_size
    assert env.occupancy_map is occ and env.cell_size == jocc.cell_size
    np.testing.assert_array_equal(occ.origin, jocc.origin)
    ref, got = np.asarray(jocc.map), occ.map.numpy()
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, 1.0}
    assert 0 < got.mean() < 1
    differ = got != ref
    if differ.any():
        # only cells whose center sits on a surface
        centers = (np.argwhere(differ) - occ.origin) * occ.cell_size
        sd = env.compute_sdf(torch.as_tensor(centers, dtype=torch.float32))
        assert float(sd.abs().max()) < 1e-6
    assert differ.sum() <= SURFACE_SHARE * differ.size


def test_lookups_match_jax(maps):
    """get_collisions (in and outside the workspace), occupied_points,
    compute_distances and compute_cost on the same map."""
    _, env, jocc, _ = maps
    occ = _same_map(jocc)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.3, 1.3, size=(3, 700, occ.dim)).astype(np.float32)
    got = occ.get_collisions(torch.as_tensor(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jocc.get_collisions(jnp.asarray(x))))
    assert 0 < float(got.mean()) < 1
    assert torch.equal(occ.compute_cost(torch.as_tensor(x)), got)
    np.testing.assert_array_equal(occ.occupied_points(),
                                  jocc.occupied_points())
    y = torch.as_tensor(x[0, :50])
    np.testing.assert_allclose(
        occ.compute_distances(y).numpy(),
        np.asarray(jocc.compute_distances(jnp.asarray(x[0, :50]))),
        atol=1e-6)
    pts = torch.as_tensor(occ.occupied_points()[:7], dtype=torch.float32)
    assert torch.equal(occ.compute_distances(y, pts),
                       occ.compute_distances(y)[:, :7])


def test_build_takes_an_explicit_device_and_chunk():
    env = EnvSpheres3D(device="cpu")
    a = build_occupancy_map(env.limits, 0.1, env.obj_all_list, device="cpu")
    b = build_occupancy_map(env.limits.tolist(), 0.1, env.obj_all_list,
                            chunk=100, device="cpu")
    assert a.cmap_dim == (20, 20, 20)
    assert torch.equal(a.map, b.map)


def _tasks(name):
    jmake, make, cell = SCENES[name]
    if name == "dense2d":
        jrobot, robot = JRobotPointMass.create(), RobotPointMass.create(
            device="cpu")
    else:
        jrobot, robot = JRobotPanda.create(), RobotPanda.create(device="cpu")
    jtask = JPlanningTask(env=jmake(), robot=jrobot, use_occupancy_map=True,
                          cell_size=cell)
    task = PlanningTask(env=make(device="cpu"), robot=robot,
                        use_occupancy_map=True, cell_size=cell)
    return jtask, task


@pytest.mark.parametrize("name", sorted(SCENES))
def test_occupancy_collision_check_matches_jax(name):
    """compute_collision through the occupancy map, over states past the
    joint limits and the workspace; the JAX map is given to the port's
    task so that the two check the same cells."""
    jtask, task = _tasks(name)
    task.env.occupancy_map = _same_map(jtask.env.occupancy_map)
    robot = task.robot
    lo, hi = robot.q_min.numpy(), robot.q_max.numpy()
    rng = np.random.default_rng(5)
    q = (lo + rng.uniform(-0.15, 1.15, size=(4, 300, lo.shape[0]))
         * (hi - lo)).astype(np.float32)
    x = np.concatenate([q, np.zeros_like(q)], -1)
    got = task.compute_collision(torch.as_tensor(x))
    ref = np.asarray(jtask.compute_collision(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1
    # the occupancy check, not the distance fields: margins are ignored
    assert torch.equal(task.compute_collision(torch.as_tensor(x), margin=0.5),
                       got)
