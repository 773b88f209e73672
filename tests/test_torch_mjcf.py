"""The port's MJCF loader (``kin/mjcf.py``) against the JAX package's on
tests/test_mjcf.py's inline two-link MJCF: the same structure, limits and
FK (to 1e-6), and that test's own assertions on the port.  The loader
needs dm_control; where ``importlib.util.find_spec`` finds none, it
raises its own ImportError (checked with find_spec patched, so it runs
whether dm_control is installed or not).
"""
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu_torch.kin import fk_all_links
from torch_robotics_tpu_torch.kin import mjcf as pmjcf

MJCF = """
<mujoco model="two_link">
  <worldbody>
    <body name="upper" pos="0 0 0.1">
      <joint name="shoulder" type="hinge" axis="0 1 0" range="-1.5 1.5"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0 0 0.3"/>
      <body name="lower" pos="0 0 0.3">
        <joint name="elbow" type="hinge" axis="0 1 0" range="-2 2"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0 0 0.25"/>
        <body name="tip" pos="0 0 0.25"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def test_missing_dm_control_raises_in_the_ports_words(monkeypatch, tmp_path):
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "dm_control" else real(name, *a))
    path = tmp_path / "two_link.xml"
    path.write_text(MJCF)
    with pytest.raises(ImportError, match="needs the dm_control package"):
        pmjcf.kinematic_model_from_mjcf(path, device="cpu")


def test_mjcf_two_link_matches_jax(tmp_path):
    pytest.importorskip("dm_control")
    from torch_robotics_tpu.kin import fk_all_links as jfk
    from torch_robotics_tpu.kin.mjcf import kinematic_model_from_mjcf
    path = tmp_path / "two_link.xml"
    path.write_text(MJCF)
    model = pmjcf.kinematic_model_from_mjcf(path, device="cpu")
    jmodel = kinematic_model_from_mjcf(path)
    assert model.n_dofs == jmodel.n_dofs == 2
    assert model.link_names == jmodel.link_names and "tip" in model.link_names
    assert model.joint_names == jmodel.joint_names
    assert model.parent_idx == jmodel.parent_idx
    assert model.joint_types == jmodel.joint_types
    for k in ("joint_trans", "joint_fixed_rot", "joint_axis", "q_lower",
              "q_upper", "joint_damping"):
        np.testing.assert_array_equal(getattr(model, k),
                                      np.asarray(getattr(jmodel, k)), k)
    q = np.array([[0.0, 0.0], [0.0, np.pi / 2], [0.7, -1.1]], np.float32)
    H = fk_all_links(model, torch.as_tensor(q), link_list=["tip"])
    np.testing.assert_allclose(
        H, jfk(jmodel, jnp.asarray(q), link_list=["tip"]), atol=1e-6)
    np.testing.assert_allclose(H[0, 0, :3, 3], [0, 0, 0.65], atol=1e-6)
    np.testing.assert_allclose(H[1, 0, :3, 3], [0.25, 0, 0.4], atol=1e-5)
    np.testing.assert_allclose(model.q_lower, [-1.5, -2.0])
    np.testing.assert_allclose(model.q_upper, [1.5, 2.0])
