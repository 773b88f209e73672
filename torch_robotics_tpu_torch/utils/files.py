"""Data-path resolution + yaml loading (counterpart of
torch_robotics_tpu/utils/files.py).

The data assets (URDFs, collision-sphere yamls, ``env_layouts.json``) are
read in place, read-only, from the JAX package's ``data`` directory, which
is found relative to this file; the JAX package is never imported.
"""
from __future__ import annotations

from pathlib import Path

import yaml

__all__ = ["get_data_path", "get_urdf_path", "get_robot_path",
           "get_configs_path", "load_yaml"]


def get_data_path() -> Path:
    return Path(__file__).resolve().parents[2] / "torch_robotics_tpu" / "data"


def get_urdf_path() -> Path:
    return get_data_path() / "urdf"


def get_robot_path() -> Path:
    return get_urdf_path() / "robots"


def get_configs_path() -> Path:
    return get_data_path() / "configs"


def load_yaml(filename):
    with open(filename, "r") as stream:
        return yaml.safe_load(stream)
