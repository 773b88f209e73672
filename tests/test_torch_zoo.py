"""The port's robot zoo against the JAX package's: every constructor's
model (name, link names, joints, limits) and its FK on the same numpy q,
the reference goldens of the branching trees, the lane FK chain on them,
``KinematicModel.from_urdf`` and the UR10 with its suction gripper.

FK is float32 in both packages: the JAX golden tolerance (2e-5,
tests/test_kin_fk.py) holds between them as against the goldens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import load_golden
from torch_robotics_tpu.kin import fk_all_links as jfk_all_links
from torch_robotics_tpu.kin import robot_zoo as jzoo
from torch_robotics_tpu_torch.kin import (KinematicModel, fk_all_links,
                                          fk_rot_trans, robot_zoo)
from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
from torch_robotics_tpu_torch.utils.files import get_robot_path

FK_ATOL = 2e-5

# constructor name -> keyword arguments; the nine models of the JAX zoo
ZOO = {
    "kuka_iiwa7": {}, "franka_panda": {}, "ur10": {},
    "ur10_gripper": {"attach_gripper": True}, "habitat_stretch": {},
    "tiago_dual_holo": {}, "tiago_dual_holo_move": {}, "shadow_hand": {},
    "allegro_hand": {}, "planar_2_link": {},
}


def _ctor(name):
    return name.split("_gripper")[0]


@pytest.fixture(scope="module")
def models():
    return {n: (getattr(robot_zoo, _ctor(n))(device="cpu", **kw),
                getattr(jzoo, _ctor(n))(**kw)) for n, kw in ZOO.items()}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_model_matches_jax(models, name):
    m, jm = models[name]
    assert m.name == jm.name
    assert m.link_names == jm.link_names
    assert m.parent_idx == jm.parent_idx
    assert m.joint_types == jm.joint_types
    assert m.n_dofs == jm.n_dofs
    np.testing.assert_array_equal(m.q_lower, np.asarray(jm.q_lower))
    np.testing.assert_array_equal(m.q_upper, np.asarray(jm.q_upper))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_fk_matches_jax(models, name):
    """fk_all_links on q over 1.4x the joint range (clamped joints
    included), against the JAX package's, jitted."""
    m, jm = models[name]
    lo, hi = m.q_lower.astype(np.float64), m.q_upper.astype(np.float64)
    u = np.random.default_rng(len(name)).uniform(-0.2, 1.2, (16, m.n_dofs))
    q = (lo + u * (hi - lo)).astype(np.float32)
    H = fk_all_links(m, torch.as_tensor(q)).numpy()
    jH = np.asarray(jax.jit(lambda x: jfk_all_links(jm, x))(jnp.asarray(q)))
    assert H.shape == jH.shape == (16, m.n_links, 4, 4)
    np.testing.assert_allclose(H, jH, atol=FK_ATOL)


@pytest.mark.parametrize("golden,name,exclude", [
    # the Shadow hand's lf* chain hangs off LFJ5, whose axis is not axis
    # aligned: the reference turns it about z, both packages about the
    # true axis (tests/test_kin_fk.py:155-160)
    ("shadow_hand_fk", "shadow_hand", "lf"),
    ("allegro_hand_fk", "allegro_hand", None),
    ("tiago_dual_fk", "tiago_dual_holo", None),
    ("kuka_iiwa7_fk", "kuka_iiwa7", None),
    ("stretch_fk", "habitat_stretch", None),
])
def test_fk_golden(models, golden, name, exclude):
    g = load_golden(golden)
    m = models[name][0]
    assert list(m.link_names) == list(g["link_names"])
    H = fk_all_links(m, torch.as_tensor(g["q"])).numpy()
    keep = [i for i, n in enumerate(g["link_names"])
            if exclude is None or not n.startswith(exclude)]
    assert len(keep) >= len(g["link_names"]) - 6
    np.testing.assert_allclose(H[:, keep], np.asarray(g["link_tensor"])[
        :, keep], atol=FK_ATOL)


def test_shadow_lfj5_turns_about_its_axis(models):
    """LFJ5 (palm -> lfmetacarpal) against a closed-form rotation about its
    URDF axis composed onto the palm's pose."""
    g = load_golden("shadow_hand_fk")
    m = models["shadow_hand"][0]
    names = list(m.link_names)
    q = np.asarray(g["q"])
    H = fk_all_links(m, torch.as_tensor(q)).numpy()
    i_palm, i_lfm = names.index("palm"), names.index("lfmetacarpal")
    dof = int(m.q_map[i_lfm])
    axis = np.array([0.573576436, 0.0, 0.819152044])
    angle = np.clip(q[:, dof], 0.0, 0.69813170079773179)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    T_origin = np.eye(4)
    T_origin[:3, 3] = [-0.033, 0.0, 0.02071]
    for b in range(q.shape[0]):
        T_rot = np.eye(4)
        T_rot[:3, :3] = (np.eye(3) + np.sin(angle[b]) * K
                         + (1 - np.cos(angle[b])) * (K @ K))
        np.testing.assert_allclose(H[b, i_lfm],
                                   H[b, i_palm] @ T_origin @ T_rot,
                                   atol=FK_ATOL)


@pytest.mark.parametrize("name", ["shadow_hand", "allegro_hand",
                                  "tiago_dual_holo", "tiago_dual_holo_move",
                                  "habitat_stretch"])
def test_lanes_fk_follows_the_tree(models, name):
    """The lane chain follows parent pointers on the branching trees (and
    the Stretch's prismatic joints), as the AoS chain does (JAX
    tests/test_lanes_terms.py:84-96)."""
    m = models[name][0]
    u = np.random.default_rng(11).uniform(-2.0, 2.0, (4, 3, m.n_dofs))
    q = torch.as_tensor(u, dtype=torch.float32)
    t_lanes = fk_positions_lanes(m, q)
    _, t_ref = fk_rot_trans(m, q)
    assert tuple(t_lanes.shape) == (4, 3, m.n_links, 3)
    np.testing.assert_allclose(t_lanes.numpy(), t_ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_from_urdf(models):
    """from_urdf reads a URDF file in place: the robot's own name unless
    one is given, the zoo's model otherwise."""
    path = get_robot_path() / "allegro_hand/allegro_hand.urdf"
    m = KinematicModel.from_urdf(path, device="cpu")
    jm = models["allegro_hand"][1]
    assert m.name == type(jm).from_urdf(path).name != jm.name
    named = KinematicModel.from_urdf(path, name="differentiable_allegro_hand",
                                     device="cpu")
    zoo = models["allegro_hand"][0]
    assert named.name == zoo.name and named.link_names == zoo.link_names
    for k in ("joint_trans", "joint_fixed_rot", "joint_axis", "q_lower"):
        np.testing.assert_array_equal(getattr(named, k), getattr(zoo, k))


def test_ur10_suction_gripper(models):
    """The suction gripper adds one fixed link past ee_link and no joint."""
    bare, grip = models["ur10"][0], models["ur10_gripper"][0]
    assert grip.link_names == bare.link_names + ("ee_suction_link",)
    assert grip.n_dofs == bare.n_dofs == 6
    q = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (5, 6)),
                        dtype=torch.float32)
    np.testing.assert_allclose(fk_all_links(grip, q)[:, :-1].numpy(),
                               fk_all_links(bare, q).numpy(), atol=1e-6)
