"""The port's utils (``utils/serialization.py``, ``utils/logging.py``,
``utils/profiling.py``, ``utils/files.py``) and posed objects
(``geom/sdf.py``: ``ObjectField.with_pose``, ``compute_signed_distance``,
the boxes' ``sizes``) against the JAX package:

- a grid (EnvDense2D at 0.02, tests/test_serialization_occmap.py:13-36)
  and the Panda's model saved by either package load in the other with
  equal arrays and structure; the loaded grid's lookups equal the
  original's bit for bit, the loaded model's FK to 1e-7;
- ``log_every`` emits on calls 0, 2, 4 of 6 at every = 2
  (tests/test_logging_and_net.py:13);
- ``trace_to`` writes a trace holding an ``annotate`` span;
  ``SectionTimer`` counts and times sections;
- a re-posed object: its SDF and a Panda task's plain terms against the
  JAX package's on the same re-posed object, to 1e-5 of max|ref|, and
  the kernels' scene packing carries the new pose.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu.envs import EnvBase as JEnvBase
from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.geom import precompute_sdf_grid as jprecompute
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu.kin.fk import fk_all_links as jfk
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_factory as jax_terms_factory
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu.utils import serialization as jser
from torch_robotics_tpu_torch.envs import EnvBase, EnvDense2D, EnvSpheres3D
from torch_robotics_tpu_torch.geom import precompute_sdf_grid
from torch_robotics_tpu_torch.geom.sdf import RoundedBoxes, SharpBoxes
from torch_robotics_tpu_torch.kin import fk_all_links, robot_zoo
from torch_robotics_tpu_torch.ops.terms_kernel import _pack_scene
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask
from torch_robotics_tpu_torch.utils import files
from torch_robotics_tpu_torch.utils import serialization as pser
from torch_robotics_tpu_torch.utils.logging import (MetricsAccumulator,
                                                    log_every)
from torch_robotics_tpu_torch.utils.profiling import (SectionTimer,
                                                      annotate, trace_to)

X2 = np.float32([[0.3, -0.2], [0.0, 0.0], [-0.7, 0.7], [0.95, -0.95]])


@pytest.fixture(scope="module")
def grids():
    jenv = JEnvDense2D()
    env = EnvDense2D(device="cpu")
    return (precompute_sdf_grid(env.limits, 0.02, env.obj_fixed_list,
                                device="cpu"),
            jprecompute(jenv.limits, 0.02, jenv.obj_fixed_list))


def test_grid_saved_by_either_package_loads_in_the_other(grids, tmp_path):
    grid, jgrid = grids
    pser.save_grid_sdf(tmp_path / "p.npz", grid)
    jser.save_grid_sdf(tmp_path / "j.npz", jgrid)
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
    np.testing.assert_allclose(a["sdf_grid"], b["sdf_grid"], atol=1e-6)
    from_j = pser.load_grid_sdf(tmp_path / "j.npz", device="cpu")
    from_p = jser.load_grid_sdf(tmp_path / "p.npz")
    for k in ("limits", "sdf_grid", "grad_grid"):
        np.testing.assert_array_equal(getattr(from_j, k).numpy(),
                                      np.asarray(getattr(jgrid, k)))
        np.testing.assert_array_equal(np.asarray(getattr(from_p, k)),
                                      getattr(grid, k).numpy())
    assert from_j.cmap_dim == jgrid.cmap_dim and from_p.cmap_dim == grid.cmap_dim
    x = torch.as_tensor(X2)
    np.testing.assert_array_equal(
        pser.load_grid_sdf(tmp_path / "p.npz", device="cpu")
        .signed_distance(x).numpy(), grid.signed_distance(x).numpy())


def test_model_saved_by_either_package_loads_in_the_other(tmp_path):
    model, jmodel = robot_zoo.franka_panda(device="cpu"), jzoo.franka_panda()
    pser.save_kinematic_model(tmp_path / "p.npz", model)
    jser.save_kinematic_model(tmp_path / "j.npz", jmodel)
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k == "__meta__":
            assert (json.loads(bytes(a[k]).decode())
                    == json.loads(bytes(b[k]).decode()))
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    from_j = pser.load_kinematic_model(tmp_path / "j.npz", device="cpu")
    from_p = jser.load_kinematic_model(tmp_path / "p.npz")
    assert from_j.link_names == jmodel.link_names
    assert from_j.n_dofs == jmodel.n_dofs == from_p.n_dofs
    assert from_p.joint_names == jmodel.joint_names
    q = np.full((2, 7), 0.3, np.float32)
    ref = np.asarray(jfk(jmodel, jnp.asarray(q)))
    np.testing.assert_allclose(fk_all_links(from_j, torch.as_tensor(q)),
                               ref, atol=1e-7)
    np.testing.assert_allclose(jfk(from_p, jnp.asarray(q)), ref, atol=1e-7)
    np.testing.assert_array_equal(
        fk_all_links(from_j, torch.as_tensor(q)).numpy(),
        fk_all_links(model, torch.as_tensor(q)).numpy())


def test_log_every_and_accumulator():
    acc = MetricsAccumulator()
    log_fn = log_every("test/cost", every=2, printer=acc.printer("test/cost"))
    c = torch.tensor(0.0)
    for i in range(6):
        log_fn(i, c)
        c = c + 1.0
    assert float(c) == 6.0
    assert acc.as_dict() == {"test/cost": [(0, 0.0), (2, 2.0), (4, 4.0)]}
    log_every("test/quiet", every=3)(0, 1.0)     # the default printer


def test_trace_and_section_timer(tmp_path):
    x = torch.ones(64, 64)
    with trace_to(tmp_path / "trace") as prof:
        with annotate("port/matmul"):
            y = x @ x
    assert "port/matmul" in {e.key for e in prof.key_averages()}
    written = list((tmp_path / "trace").glob("*.json"))
    assert len(written) == 1 and "port/matmul" in written[0].read_text()
    timer = SectionTimer()
    for _ in range(3):
        with timer.section("mm", y):
            y = y @ x
    with timer.section("none"):
        pass
    s = timer.summary()
    assert s["mm"]["count"] == 3 and s["none"]["count"] == 1
    assert s["mm"]["total_s"] >= 0.0 and list(s) == ["mm", "none"]


def test_files_paths():
    from torch_robotics_tpu.utils.files import get_objects_path as jpath
    assert files.get_objects_path().resolve() == jpath().resolve()
    assert files.get_objects_path().parent == files.get_urdf_path()


POSE = (np.float32([0.1, -0.2, 0.05]),
        np.float32([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3,
                                                            0.2]))


def test_box_sizes_and_signed_distance_alias():
    c = torch.zeros(2, 3)
    s = torch.tensor([[0.2, 0.4, 0.6], [1.0, 1.0, 1.0]])
    assert torch.equal(SharpBoxes(c, s / 2).sizes, s)
    assert torch.equal(RoundedBoxes.from_sizes(c, s).sizes, s)
    obj = EnvSpheres3D(device="cpu").obj_fixed_list[0]
    x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (16, 3)),
                        dtype=torch.float32)
    assert torch.equal(obj.compute_signed_distance(x), obj.signed_distance(x))


def reposed_tasks():
    env0, jenv0 = EnvSpheres3D(device="cpu"), JEnvSpheres3D()
    objs = [o.with_pose(*POSE) if i == 0 else o
            for i, o in enumerate(env0.obj_fixed_list)]
    jobjs = [o.with_pose(*POSE) if i == 0 else o
             for i, o in enumerate(jenv0.obj_fixed_list)]
    env = EnvBase(limits=env0.limits.numpy(), obj_fixed_list=objs,
                  device="cpu")
    jenv = JEnvBase(limits=np.asarray(jenv0.limits), obj_fixed_list=jobjs)
    return (PlanningTask(env=env, robot=RobotPanda.create(device="cpu"),
                         obstacle_cutoff_margin=0.03),
            JPlanningTask(env=jenv, robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.03), objs, jobjs,
            env0.obj_fixed_list[0])


def test_with_pose_reaches_the_terms_and_the_scene_packing():
    task, jtask, objs, jobjs, before = reposed_tasks()
    moved = objs[0]
    assert moved.fields is before.fields and moved.name == before.name
    assert not torch.equal(moved.pos, before.pos)
    assert moved.pos.dtype == torch.float32 and moved.pos.device.type == "cpu"
    np.testing.assert_array_equal(moved.pos.numpy(), POSE[0])
    x = np.random.default_rng(1).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(moved.signed_distance(torch.as_tensor(x)),
                               jobjs[0].signed_distance(jnp.asarray(x)),
                               atol=1e-6)
    lo, hi = task.robot.model.q_lower, task.robot.model.q_upper
    q = (lo + (hi - lo) * np.random.default_rng(2).uniform(
        0.2, 0.8, (16, 7))).T.astype(np.float32)
    got = task.collision_residuals.obstacle_terms_lanes(torch.as_tensor(q),
                                                        1.0)
    ref = jax_terms_factory(jtask)(jnp.asarray(q), 1.0)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-30))
    assert float(np.abs(np.asarray(ref[2])).max()) > 0.0
    _, floats = _pack_scene(task.df_obj_list, 3)
    np.testing.assert_allclose(floats[1][0], POSE[0])
    np.testing.assert_allclose(floats[0][0],
                               moved.rotation_matrix().numpy().reshape(9))
