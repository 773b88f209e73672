"""The port's scene presets for sGPMP against the JAX package's: every scene
whose layout carries an ``sgpmp`` preset gives the same ``SGPMPParams``
through ``EnvBase.get_sgpmp_params``, and a scene without one, or a robot
the preset is not for, raises as the reference raises."""
import dataclasses
import json

import pytest

from torch_robotics_tpu.envs import make_env as jmake_env
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
from torch_robotics_tpu.solve import SGPMPParams as JSGPMPParams
from torch_robotics_tpu.utils.files import get_data_path
from torch_robotics_tpu_torch.envs import make_env
from torch_robotics_tpu_torch.robots import RobotPanda, RobotPointMass
from torch_robotics_tpu_torch.solve import SGPMPParams

_LAYOUTS = json.loads((get_data_path() / "env_layouts.json").read_text())
_SGPMP_SCENES = sorted(k for k, v in _LAYOUTS.items()
                       if v["planner_params"].get("sgpmp") is not None)


def test_some_scene_has_an_sgpmp_preset():
    assert "EnvGridCircles2D" in _SGPMP_SCENES


@pytest.mark.parametrize("name", _SGPMP_SCENES)
def test_sgpmp_preset_matches_jax(name):
    robot = RobotPointMass.create(device="cpu")
    got = SGPMPParams.from_preset(
        make_env(name, device="cpu").get_sgpmp_params(robot))
    ref = JSGPMPParams.from_preset(
        jmake_env(name).get_sgpmp_params(JRobotPointMass.create()))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got == SGPMPParams.from_preset(
        make_env(name, device="cpu").get_sgpmp_params())


@pytest.mark.parametrize("name, robot_kind", [("EnvSpheres3D", "point_mass"),
                                              ("EnvGridCircles2D", "panda")])
def test_sgpmp_preset_raises_as_jax(name, robot_kind):
    robot, jrobot = ((RobotPointMass.create(device="cpu"),
                      JRobotPointMass.create()) if robot_kind == "point_mass"
                     else (RobotPanda.create(device="cpu"),
                           JRobotPanda.create()))
    with pytest.raises(NotImplementedError):
        jmake_env(name).get_sgpmp_params(jrobot)
    with pytest.raises(NotImplementedError):
        make_env(name, device="cpu").get_sgpmp_params(robot)
