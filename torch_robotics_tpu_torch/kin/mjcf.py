"""MJCF model loading (counterpart of torch_robotics_tpu/kin/mjcf.py).

An MJCF body tree becomes the ``UrdfRobot`` structure the URDF path builds
(a joint at each body's origin, hinge -> revolute, slide -> prismatic, the
body's ``pos`` folded into the joint origin), compiled by
``KinematicModel.from_urdf_robot``.  Reading MJCF needs dm_control, which
is imported only when a file is parsed; nothing else in the package needs
it.
"""
from __future__ import annotations

import importlib.util
from collections.abc import Iterable

from .model import KinematicModel
from .urdf import UrdfJoint, UrdfLink, UrdfRobot

__all__ = ["parse_mjcf", "kinematic_model_from_mjcf"]

_JOINT_MAP = {"hinge": "revolute", "slide": "prismatic", None: "revolute"}


def _joints_of(body):
    """A body's joint elements as a list: dm_control gives a list view for
    a repeated child, an element or None otherwise."""
    js = body.joint
    if js is None:
        return []
    if isinstance(js, Iterable):
        return [j for j in js if j is not None]
    return [js]


def parse_mjcf(path) -> UrdfRobot:
    """The MJCF file at ``path`` as a ``UrdfRobot`` (each body a link, its
    first joint the link's joint, a body without one fixed)."""
    if importlib.util.find_spec("dm_control") is None:
        raise ImportError(
            "reading MJCF needs the dm_control package, which is not "
            "installed; kin.mjcf is the only module that uses it")
    from dm_control import mjcf

    root = mjcf.from_file(str(path))
    links = [UrdfLink(name="worldbody")]
    joints = []

    def visit(body, parent_name):
        name = body.name or f"body_{len(links)}"
        links.append(UrdfLink(name=name))
        body_pos = tuple(body.pos) if body.pos is not None else (0.0, 0.0, 0.0)
        body_joints = _joints_of(body)
        if not body_joints:
            joints.append(UrdfJoint(
                name=f"{name}_fixed", type="fixed", parent=parent_name,
                child=name, origin_xyz=body_pos, origin_rpy=(0.0, 0.0, 0.0),
                axis=(0.0, 0.0, 0.0)))
        else:
            j = body_joints[0]
            jpos = tuple(j.pos) if j.pos is not None else (0.0, 0.0, 0.0)
            joint = UrdfJoint(
                name=j.name or f"{name}_joint",
                type=_JOINT_MAP.get(j.type, "revolute"),
                parent=parent_name, child=name,
                origin_xyz=tuple(bp + jp for bp, jp in zip(body_pos, jpos)),
                origin_rpy=(0.0, 0.0, 0.0),
                axis=tuple(j.axis) if j.axis is not None else (0.0, 0.0, 1.0))
            if j.range is not None:
                joint.has_limit = True
                joint.limit_lower = float(j.range[0])
                joint.limit_upper = float(j.range[1])
            if j.damping is not None:
                joint.damping = float(j.damping)
            joints.append(joint)
        for child in body.body:
            visit(child, name)

    for body in root.worldbody.body:
        visit(body, "worldbody")
    return UrdfRobot(name=root.model or "mjcf_robot", links=links,
                     joints=joints)


def kinematic_model_from_mjcf(path, name=None,
                              device="cuda") -> KinematicModel:
    """The kinematic model of the MJCF file at ``path``, for ``device``."""
    robot = parse_mjcf(path)
    return KinematicModel.from_urdf_robot(robot, name=name or robot.name,
                                          device=device)
