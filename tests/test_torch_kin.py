"""Port kinematics vs the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import load_golden
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    fk_positions_lanes as jax_fk_positions_lanes
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_arrays, task_from_numpy
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.kin import fk_all_links
from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask


_JAX_GROUP_FIELDS = {
    "Spheres": ("spheres", ("centers", "radii")),
    "RoundedBoxes": ("rounded_boxes", ("centers", "half_sizes",
                                       "round_radii")),
    "SharpBoxes": ("sharp_boxes", ("centers", "half_sizes")),
}


def export_jax_task(task):
    """A JAX PlanningTask's parameters as numpy arrays, in the format of
    torch_robotics_tpu_torch.convert.task_from_numpy."""
    robot, model = task.robot, task.robot.model
    out = {k: np.asarray(getattr(model, k)) for k in (
        "joint_trans", "joint_fixed_rot", "joint_axis", "clamp_lower",
        "clamp_upper", "q_lower", "q_upper")}
    out.update(
        joint_types=np.asarray(model.joint_types, np.int32),
        parent_idx=np.asarray(model.parent_idx, np.int32),
        q_map=np.asarray(model.q_map, np.int32),
        link_names=list(model.link_names),
        object_coll_idxs=np.asarray(robot.object_coll_idxs, np.int32),
        self_coll_idxs=np.asarray(robot.self_coll_idxs, np.int32),
        self_pair_idxs=np.asarray(robot.self_pair_idxs,
                                  np.int32).reshape(-1, 2),
        object_margins=np.asarray(robot.object_margins),
        self_margins=np.asarray(robot.self_margins),
        ws_limits=np.asarray(task.ws_limits),
        obstacle_cutoff_margin=np.float64(task.obstacle_cutoff_margin),
        objects=[])
    for obj in task.df_obj_list:
        groups = []
        for f in obj.fields:
            kind, names = _JAX_GROUP_FIELDS[type(f).__name__]
            groups.append({"kind": kind, **{n: np.asarray(getattr(f, n))
                                            for n in names}})
        out["objects"].append({"pos": np.asarray(obj.pos),
                               "ori": np.asarray(obj.ori), "groups": groups})
    return out


@pytest.fixture(scope="module")
def panda():
    return RobotPanda.create(device="cpu")


def test_fk_positions_match_jax_incl_clamped(panda):
    """Random q over 1.6x the joint range (many joints past their clamps):
    float32 FK chains in another op order, atol 1e-5 (metres)."""
    jrobot = JRobotPanda.create()
    rng = np.random.default_rng(0)
    lo, hi = panda.model.q_lower, panda.model.q_upper
    q = (lo + rng.uniform(-0.3, 1.3, size=(3, 5, 7)) * (hi - lo)).astype(
        np.float32)
    ref = np.asarray(jax_fk_positions_lanes(jrobot.model, jnp.asarray(q)))
    got = fk_positions_lanes(panda.model, torch.as_tensor(q)).numpy()
    assert got.shape == ref.shape == (3, 5, panda.model.n_links, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_fk_matches_golden(panda):
    """Link poses vs the original torch_robotics goldens, at the JAX
    package's own bound (tests/test_kin_fk.py, atol 2e-5)."""
    g = load_golden("panda_fk")
    assert list(panda.model.link_names) == g["link_names"]
    np.testing.assert_allclose(panda.model.q_lower, g["joint_lower"],
                               atol=1e-6)
    H = fk_all_links(panda.model, torch.as_tensor(g["q"])).numpy()
    np.testing.assert_allclose(H, g["link_tensor"], atol=2e-5)


def test_model_arrays_equal_jax(panda):
    jmodel = JRobotPanda.create().model
    for k in ("joint_trans", "joint_fixed_rot", "joint_axis", "clamp_lower",
              "clamp_upper", "q_lower", "q_upper", "q_map"):
        np.testing.assert_array_equal(getattr(panda.model, k),
                                      np.asarray(getattr(jmodel, k)))
    assert panda.model.parent_idx == jmodel.parent_idx
    assert panda.model.joint_types == jmodel.joint_types
    assert panda.model.topological_order() == jmodel.topological_order()
    np.testing.assert_array_equal(panda.model.ancestry_matrix(),
                                  jmodel.ancestry_matrix())


def _assert_arrays_equal(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if k == "objects":
            assert len(a[k]) == len(b[k])
            for oa, ob in zip(a[k], b[k]):
                np.testing.assert_array_equal(oa["pos"], ob["pos"])
                np.testing.assert_array_equal(oa["ori"], ob["ori"])
                for ga, gb in zip(oa["groups"], ob["groups"], strict=True):
                    assert ga.keys() == gb.keys()
                    for n in ga:
                        if n == "kind":
                            assert ga[n] == gb[n]
                        else:
                            np.testing.assert_array_equal(ga[n], gb[n])
        elif k == "link_names":
            assert list(a[k]) == list(b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_task_from_numpy_equals_port_urdf_task(panda):
    """The arrays exported from the JAX task, the port's own URDF-built
    Panda in EnvSpheres3D, and the task rebuilt from the arrays are the
    same arrays, bit for bit."""
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=JRobotPanda.create(),
                          obstacle_cutoff_margin=0.03)
    exported = export_jax_task(jtask)
    own = task_arrays(PlanningTask(env=EnvSpheres3D(device="cpu"),
                                   robot=panda, obstacle_cutoff_margin=0.03))
    _assert_arrays_equal(exported, own)
    rebuilt = task_arrays(task_from_numpy(exported, device="cpu"))
    _assert_arrays_equal(exported, rebuilt)


def test_rotation_helpers_match_jax():
    """quaternion / se3 helpers on random inputs, float32 (1e-6)."""
    from torch_robotics_tpu.core import quaternion as jq
    from torch_robotics_tpu.core import se3 as jse3
    from torch_robotics_tpu_torch.core import quaternion, se3
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    R = np.array(jq.q_to_rotation_matrix(jnp.asarray(q)))
    np.testing.assert_allclose(
        quaternion.q_to_rotation_matrix(torch.as_tensor(q)).numpy(), R,
        atol=1e-6)
    np.testing.assert_allclose(
        quaternion.rotation_matrix_to_q(torch.as_tensor(R)).numpy(),
        np.asarray(jq.rotation_matrix_to_q(jnp.asarray(R))), atol=1e-6)
    rpy = rng.uniform(-3, 3, size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        se3.rpy_to_rotation_matrix(torch.as_tensor(rpy)).numpy(),
        np.asarray(jse3.rpy_to_rotation_matrix(jnp.asarray(rpy))), atol=1e-6)
    axis = rng.normal(size=(5, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, size=5).astype(np.float32)
    np.testing.assert_allclose(
        se3.axis_angle_rotation(torch.as_tensor(axis),
                                torch.as_tensor(ang)).numpy(),
        np.asarray(jse3.axis_angle_rotation(jnp.asarray(axis),
                                            jnp.asarray(ang))), atol=1e-6)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        se3.rotate_point(torch.as_tensor(p), torch.as_tensor(R[:5])).numpy(),
        np.asarray(jse3.rotate_point(jnp.asarray(p), jnp.asarray(R[:5]))),
        atol=1e-6)


def test_collision_points_and_interpolation_match_jax(panda):
    from torch_robotics_tpu.costs.fields import \
        interpolate_points as jax_interpolate_points
    from torch_robotics_tpu_torch.costs import interpolate_points
    jrobot = JRobotPanda.create()
    rng = np.random.default_rng(3)
    lo, hi = panda.model.q_lower, panda.model.q_upper
    q = (lo + rng.uniform(size=(4, 7)) * (hi - lo)).astype(np.float32)
    jl = jrobot.fk_map_collision(jnp.asarray(q))
    pl = panda.fk_map_collision(torch.as_tensor(q))
    np.testing.assert_allclose(
        panda.object_collision_points(pl).numpy(),
        np.asarray(jrobot.object_collision_points(jl)), atol=1e-5)
    np.testing.assert_allclose(
        panda.self_collision_points(pl).numpy(),
        np.asarray(jrobot.self_collision_points(jl)), atol=1e-5)
    for n in (5, 12):
        np.testing.assert_allclose(
            interpolate_points(pl, n).numpy(),
            np.asarray(jax_interpolate_points(jl, n)), atol=1e-5)
