"""Minimal URDF parser (host-side; the port's own copy of
torch_robotics_tpu/kin/urdf.py).

A small xml.etree parser extracting exactly the fields the kinematics needs:
link names, joint topology, joint origins (xyz/rpy), types, axes, limits,
damping, and inertial parameters.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree as ET

__all__ = ["UrdfJoint", "UrdfLink", "UrdfRobot", "parse_urdf"]


def _vec(s: Optional[str], default=(0.0, 0.0, 0.0)) -> Tuple[float, ...]:
    if s is None:
        return tuple(default)
    return tuple(float(v) for v in s.split())


@dataclasses.dataclass
class UrdfJoint:
    name: str
    type: str               # revolute | continuous | prismatic | fixed | floating | planar
    parent: str
    child: str
    origin_xyz: Tuple[float, float, float]
    origin_rpy: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    limit_lower: float = 0.0
    limit_upper: float = 0.0
    limit_effort: float = 0.0
    limit_velocity: float = 0.0
    has_limit: bool = False
    damping: float = 0.0


@dataclasses.dataclass
class UrdfLink:
    name: str
    mass: float = 1.0
    com: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    inertia: Tuple[float, ...] = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)  # ixx ixy ixz iyy iyz izz
    has_inertial: bool = False


@dataclasses.dataclass
class UrdfRobot:
    name: str
    links: List[UrdfLink]
    joints: List[UrdfJoint]

    def link_names(self) -> List[str]:
        return [l.name for l in self.links]

    def joint_for_child(self) -> Dict[str, UrdfJoint]:
        return {j.child: j for j in self.joints}

    def children_of(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {l.name: [] for l in self.links}
        for j in self.joints:
            out.setdefault(j.parent, []).append(j.child)
        return out

    def root_link(self) -> str:
        children = {j.child for j in self.joints}
        roots = [l.name for l in self.links if l.name not in children]
        if len(roots) != 1:
            raise ValueError(f"expected exactly one root link, got {roots}")
        return roots[0]


def parse_urdf(path) -> UrdfRobot:
    path = Path(path)
    root = ET.parse(str(path)).getroot()
    if root.tag != "robot":
        raise ValueError(f"{path} is not a URDF (root tag {root.tag})")

    links = []
    for le in root.findall("link"):
        link = UrdfLink(name=le.get("name"))
        ie = le.find("inertial")
        if ie is not None:
            link.has_inertial = True
            mass_e = ie.find("mass")
            if mass_e is not None:
                link.mass = float(mass_e.get("value"))
            origin_e = ie.find("origin")
            if origin_e is not None:
                link.com = _vec(origin_e.get("xyz"))
            inertia_e = ie.find("inertia")
            if inertia_e is not None:
                link.inertia = tuple(float(inertia_e.get(k, 0.0)) for k in
                                     ("ixx", "ixy", "ixz", "iyy", "iyz", "izz"))
        links.append(link)

    joints = []
    for je in root.findall("joint"):
        origin_e = je.find("origin")
        axis_e = je.find("axis")
        limit_e = je.find("limit")
        dyn_e = je.find("dynamics")
        joint = UrdfJoint(
            name=je.get("name"),
            type=je.get("type"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            origin_xyz=_vec(origin_e.get("xyz") if origin_e is not None else None),
            origin_rpy=_vec(origin_e.get("rpy") if origin_e is not None else None),
            axis=_vec(axis_e.get("xyz"), (1.0, 0.0, 0.0)) if axis_e is not None
            else (0.0, 0.0, 0.0),
        )
        if limit_e is not None:
            joint.has_limit = True
            joint.limit_lower = float(limit_e.get("lower", 0.0))
            joint.limit_upper = float(limit_e.get("upper", 0.0))
            joint.limit_effort = float(limit_e.get("effort", 0.0))
            joint.limit_velocity = float(limit_e.get("velocity", 0.0))
        if dyn_e is not None and dyn_e.get("damping") is not None:
            joint.damping = float(dyn_e.get("damping"))
        joints.append(joint)

    return UrdfRobot(name=root.get("name", path.stem), links=links, joints=joints)
