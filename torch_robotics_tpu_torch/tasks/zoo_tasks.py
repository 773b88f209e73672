"""Planning tasks for the robot zoo's robots with more than eight joints,
built from the generic ``KinematicRobot`` the same way in both packages:
the dual-arm TIAGo (14 joints) and the Shadow hand (24 joints).

Each robot's collision points are link origins (``KinematicRobot``); the
tables below are plain data, so a test can hand the same lists to the JAX
package's ``KinematicRobot.create``.

- The TIAGo's object links are the 13 links of the repo's sphere table
  (``data/configs/tiago/tiago_sphere_config.yaml``: the fixed torso and
  six links of each arm), each link's margin its largest sphere's radius;
  its self pairs are each left-arm link against each right-arm link (36
  pairs of the two arms that hang off one torso), at ``TIAGO_SELF_MARGIN``,
  about two arm spheres' radii; its end effector ``arm_left_tool_link``.
- The Shadow hand's object links are the proximal, middle and distal
  links of its five fingers, its self pairs the distal links and tips of
  different fingers; its scene (``shadow_ball_env``) a ball held in front
  of the palm, among the fingers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.base import EnvBase
from ..geom.sdf import MultiSphereField, ObjectField
from ..kin import robot_zoo
from ..robots.kinematic_robot import KinematicRobot
from ..utils.files import get_configs_path, load_yaml
from .planning_task import PlanningTask

__all__ = ["tiago_sphere_margins", "TIAGO_LEFT_LINKS", "TIAGO_RIGHT_LINKS",
           "TIAGO_SELF_PAIRS", "TIAGO_SELF_MARGIN", "TIAGO_EE",
           "SHADOW_OBJECT_LINKS", "SHADOW_OBJECT_MARGINS",
           "SHADOW_SELF_PAIRS", "SHADOW_SELF_MARGIN", "SHADOW_BALL",
           "SHADOW_LIMITS", "tiago_dual_robot", "tiago_dual_task",
           "free_start_goal",
           "shadow_hand_robot", "shadow_ball_env", "shadow_hand_task"]

TIAGO_LEFT_LINKS = tuple("arm_left_%d_link" % i for i in range(1, 7))
TIAGO_RIGHT_LINKS = tuple("arm_right_%d_link" % i for i in range(1, 7))
TIAGO_SELF_PAIRS = {a: list(TIAGO_RIGHT_LINKS) for a in TIAGO_LEFT_LINKS}
TIAGO_SELF_MARGIN = 0.15
TIAGO_EE = "arm_left_tool_link"

_FINGERS = ("ff", "mf", "rf", "lf", "th")
SHADOW_OBJECT_LINKS = tuple("%s%s" % (f, part) for f in _FINGERS
                            for part in ("proximal", "middle", "distal"))
SHADOW_OBJECT_MARGINS = tuple(
    {"proximal": 0.012, "middle": 0.011, "distal": 0.01}[n[2:]]
    for n in SHADOW_OBJECT_LINKS)
SHADOW_SELF_PAIRS = {
    "%s%s" % (f, part): ["%s%s" % (g, p2) for g in _FINGERS[i + 1:]
                         for p2 in ("distal", "tip")]
    for i, f in enumerate(_FINGERS[:-1]) for part in ("distal", "tip")}
SHADOW_SELF_MARGIN = 0.02
# the ball among the fingers: centre, radius; the hand's workspace box
SHADOW_BALL = ((0.0, -0.06, 0.38), 0.04)
SHADOW_LIMITS = ((-0.3, -0.3, 0.0), (0.3, 0.3, 0.6))


def tiago_sphere_margins():
    """(links, margins): the sphere table's links in its order and each
    link's largest sphere radius."""
    table = load_yaml(get_configs_path() / "tiago" /
                      "tiago_sphere_config.yaml")
    links = [k for k, v in table.items() if isinstance(v, list)]
    return links, [max(float(s[3]) for s in table[k]) for k in links]


def tiago_dual_robot(device="cuda") -> KinematicRobot:
    """The dual-arm TIAGo (``robot_zoo.tiago_dual_holo``) as a
    ``KinematicRobot`` with the sphere table's links and margins and the
    left-right arm pairs."""
    links, margins = tiago_sphere_margins()
    return KinematicRobot.create(
        robot_zoo.tiago_dual_holo(device=device), object_coll_links=links,
        object_coll_margins=margins, self_coll_pairs=TIAGO_SELF_PAIRS,
        self_collision_margin=TIAGO_SELF_MARGIN, link_name_ee=TIAGO_EE,
        name="TiagoDualHolo")


def tiago_dual_task(env, device="cuda",
                    obstacle_cutoff_margin: float = 0.03) -> PlanningTask:
    """The dual-arm TIAGo planning in ``env`` (on ``device``)."""
    return PlanningTask(env=env, robot=tiago_dual_robot(device),
                        obstacle_cutoff_margin=obstacle_cutoff_margin)


def free_start_goal(task: PlanningTask, n: int, seed: int = 0,
                    pool: int = 8192):
    """n start and n goal states (n, 2 d) float32 numpy, at rest, free
    with the task's margins: bench.py's draw (a numpy generator seeded
    ``seed``: starts in the lower quarter of each joint's range, goals in
    the upper quarter) of ``pool`` candidates each, the first n free ones
    kept.  Raises RuntimeError where fewer than n are free."""
    lo = task.robot.model.q_lower.astype(np.float64)
    hi = task.robot.model.q_upper.astype(np.float64)
    rng = np.random.default_rng(seed)
    u1 = rng.uniform(size=(pool, lo.shape[0]))
    u2 = rng.uniform(size=(pool, lo.shape[0]))
    out = []
    for q in (lo + 0.25 * (hi - lo) * (1 + u1) / 2,
              hi - 0.25 * (hi - lo) * (1 + u2) / 2):
        q = q.astype(np.float32)
        coll = task.compute_collision(torch.as_tensor(q, device=task.device))
        free = q[~coll.cpu().numpy()]
        if free.shape[0] < n:
            raise RuntimeError("%d of %d candidates free, %d asked"
                               % (free.shape[0], pool, n))
        out.append(np.concatenate([free[:n], np.zeros_like(free[:n])], -1))
    return out[0], out[1]


def shadow_hand_robot(device="cuda") -> KinematicRobot:
    """The Shadow hand (``robot_zoo.shadow_hand``) as a ``KinematicRobot``
    with its finger links and fingertip pairs."""
    return KinematicRobot.create(
        robot_zoo.shadow_hand(device=device),
        object_coll_links=SHADOW_OBJECT_LINKS,
        object_coll_margins=SHADOW_OBJECT_MARGINS,
        self_coll_pairs=SHADOW_SELF_PAIRS,
        self_collision_margin=SHADOW_SELF_MARGIN, link_name_ee="thtip",
        name="ShadowHand")


def shadow_ball_env(device="cuda") -> EnvBase:
    """A ball (``SHADOW_BALL``) in front of the Shadow hand's palm, within
    the fingers' reach, in the box ``SHADOW_LIMITS``."""
    center, radius = SHADOW_BALL
    ball = MultiSphereField([center], [radius], device=device)
    return EnvBase(name="ShadowBall", limits=[list(v) for v in SHADOW_LIMITS],
                   obj_fixed_list=[ObjectField.create(
                       [ball], name="ball", device=device)], device=device)


def shadow_hand_task(env=None, device="cuda",
                     obstacle_cutoff_margin: float = 0.01) -> PlanningTask:
    """The Shadow hand in ``env`` (``shadow_ball_env`` when None) on
    ``device``."""
    return PlanningTask(
        env=shadow_ball_env(device) if env is None else env,
        robot=shadow_hand_robot(device),
        obstacle_cutoff_margin=obstacle_cutoff_margin)
