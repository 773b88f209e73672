"""Carry a planning task across as numpy arrays.

``task_from_numpy`` builds the port's PlanningTask from the parameters of
the reference objects (kinematic model, scene primitives with poses,
collision tables, workspace), so one test can feed both packages the same
task.  ``task_arrays`` exports a port task in the same format.

Array dict keys:

- model: ``joint_trans`` (L, 3), ``joint_fixed_rot`` (L, 3, 3),
  ``joint_axis`` (L, 3), ``clamp_lower`` / ``clamp_upper`` (L,),
  ``joint_types`` (L,), ``parent_idx`` (L,), ``q_map`` (L,),
  ``q_lower`` / ``q_upper`` (d,), optional ``link_names``;
- collision: ``object_coll_idxs``, ``self_coll_idxs``, ``self_pair_idxs``
  (K, 2), ``object_margins``, ``self_margins``;
- workspace: ``ws_limits`` (2, 3), ``obstacle_cutoff_margin`` ();
- scene: ``objects``, a list of {``pos`` (3,), ``ori`` wxyz (4,),
  ``groups``: [{``kind``: "spheres" | "rounded_boxes" | "sharp_boxes",
  ``centers``, and ``radii`` | ``half_sizes`` [+ ``round_radii``]}]}.

A multi-robot task carries, instead of the model and collision keys,
``members`` (a list of dicts with the model and collision keys of each
arm), ``base_rots`` (n, 3, 3), ``base_trans`` (n, 3), and the MultiRobot's
own ``self_pair_idxs`` (K, 2) over its full collision layout with their
``self_margins`` (K,).

A point-mass task carries ``robot`` = "point_mass", ``q_limits`` (2, d),
``object_margins`` (1,), ``dt`` () and ``name`` instead; its scene is
``objects`` as above (2-D groups for a 2-D scene), or, where ``objects``
is absent, ``env_name``, a scene of the layout data (``envs.make_env``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .envs.base import EnvBase
from .envs.zoo import make_env
from .geom.sdf import ObjectField, RoundedBoxes, SharpBoxes, Spheres
from .kin.model import KinematicModel
from .robots.kinematic_robot import KinematicRobot
from .robots.multi_robot import MultiRobot
from .robots.panda import RobotPanda
from .robots.point_mass import RobotPointMass
from .tasks.planning_task import PlanningTask

__all__ = ["task_from_numpy", "task_arrays", "MODEL_KEYS"]

_ROBOT_KEYS = ("object_coll_idxs", "self_coll_idxs", "self_pair_idxs",
               "object_margins", "self_margins")

MODEL_KEYS = ("joint_trans", "joint_fixed_rot", "joint_axis", "clamp_lower",
              "clamp_upper", "q_lower", "q_upper")
_GROUP_FIELDS = {
    "spheres": (Spheres, ("centers", "radii")),
    "rounded_boxes": (RoundedBoxes, ("centers", "half_sizes", "round_radii")),
    "sharp_boxes": (SharpBoxes, ("centers", "half_sizes")),
}


def _f32(a, dev):
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def _robot_from_numpy(arrays: dict, dev, cls=RobotPanda):
    """One kinematic robot from its model and collision keys."""
    joint_types = tuple(int(t) for t in np.asarray(arrays["joint_types"]))
    q_map = np.asarray(arrays["q_map"], np.int32)
    n_links = len(joint_types)
    link_names = tuple(arrays.get("link_names",
                                  ["link%d" % i for i in range(n_links)]))
    model = KinematicModel(
        **{k: np.asarray(arrays[k], np.float32) for k in MODEL_KEYS},
        q_map=q_map,
        parent_idx=tuple(int(p) for p in np.asarray(arrays["parent_idx"])),
        joint_types=joint_types, device=dev, link_names=link_names)
    return cls(
        model=model,
        q_min=_f32(arrays["q_lower"], dev),
        q_max=_f32(arrays["q_upper"], dev),
        object_margins=_f32(arrays["object_margins"], dev),
        self_margins=_f32(arrays["self_margins"], dev),
        object_coll_idxs=tuple(int(i) for i in arrays["object_coll_idxs"]),
        self_coll_idxs=tuple(int(i) for i in arrays["self_coll_idxs"]),
        self_pair_idxs=tuple(tuple(int(v) for v in p) for p in
                             np.asarray(arrays["self_pair_idxs"]).reshape(
                                 -1, 2)),
    )


def task_from_numpy(arrays: dict, device="cuda") -> PlanningTask:
    """Build the port's PlanningTask from exported arrays (module doc)."""
    dev = resolve_device(device)
    if arrays.get("robot") == "point_mass":
        robot = RobotPointMass.create(
            q_limits=np.asarray(arrays["q_limits"], np.float64),
            margin=float(np.asarray(arrays["object_margins"]).reshape(-1)[0]),
            dt=float(arrays.get("dt", 1.0)),
            name=str(arrays.get("name", "RobotPointMass")), device=dev)
    elif "members" in arrays:
        robot = MultiRobot.from_pairs(
            [_robot_from_numpy(m, dev, KinematicRobot)
             for m in arrays["members"]],
            np.asarray(arrays["base_rots"]), np.asarray(arrays["base_trans"]),
            arrays["self_pair_idxs"], arrays["self_margins"])
    else:
        robot = _robot_from_numpy(arrays, dev)
    cutoff = float(arrays["obstacle_cutoff_margin"])
    if "objects" not in arrays:
        env = make_env(str(arrays["env_name"]), device=dev)
        return PlanningTask(env=env, robot=robot,
                            ws_limits=arrays.get("ws_limits"),
                            obstacle_cutoff_margin=cutoff)
    objects = []
    for o in arrays["objects"]:
        groups = []
        for g in o["groups"]:
            cls, names = _GROUP_FIELDS[g["kind"]]
            groups.append(cls(*[_f32(g[n], dev) for n in names]))
        objects.append(ObjectField(tuple(groups), _f32(o["pos"], dev),
                                   _f32(o["ori"], dev)))
    env = EnvBase(name="from_numpy", limits=np.asarray(arrays["ws_limits"]),
                  obj_fixed_list=objects, device=dev)
    return PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=cutoff)


def _np(t):
    return t.detach().cpu().numpy()


def _robot_arrays(robot) -> dict:
    """A kinematic robot's model and collision keys."""
    model = robot.model
    out = {k: np.asarray(getattr(model, k)) for k in MODEL_KEYS}
    out.update(
        joint_types=np.asarray(model.joint_types, np.int32),
        parent_idx=np.asarray(model.parent_idx, np.int32),
        q_map=np.asarray(model.q_map, np.int32),
        link_names=list(model.link_names),
        object_coll_idxs=np.asarray(robot.object_coll_idxs, np.int32),
        self_coll_idxs=np.asarray(robot.self_coll_idxs, np.int32),
        self_pair_idxs=np.asarray(robot.self_pair_idxs,
                                  np.int32).reshape(-1, 2),
        object_margins=_np(robot.object_margins),
        self_margins=_np(robot.self_margins))
    return out


def task_arrays(task: PlanningTask) -> dict:
    """Export a port task in ``task_from_numpy``'s format (numpy arrays)."""
    robot = task.robot
    if isinstance(robot, RobotPointMass):
        out = dict(robot="point_mass",
                   q_limits=np.stack([_np(robot.q_min), _np(robot.q_max)]),
                   object_margins=_np(robot.object_margins),
                   dt=np.float64(robot.dt), name=robot.name)
    elif isinstance(robot, MultiRobot):
        out = dict(members=[_robot_arrays(r) for r in robot.robots],
                   base_rots=_np(robot.base_rots),
                   base_trans=_np(robot.base_trans),
                   self_pair_idxs=np.asarray(robot.self_pair_idxs,
                                             np.int32).reshape(-1, 2),
                   self_margins=_np(robot.self_margins))
    else:
        out = _robot_arrays(robot)
    out.update(ws_limits=_np(task.ws_limits),
               obstacle_cutoff_margin=np.float64(task.obstacle_cutoff_margin))
    kinds = {v[0]: (k, v[1]) for k, v in _GROUP_FIELDS.items()}
    out["objects"] = []
    for obj in task.df_obj_list:
        groups = []
        for f in obj.fields:
            kind, names = kinds[type(f)]
            groups.append({"kind": kind,
                           **{n: _np(getattr(f, n)) for n in names}})
        out["objects"].append({"pos": _np(obj.pos), "ori": _np(obj.ori),
                               "groups": groups})
    return out
