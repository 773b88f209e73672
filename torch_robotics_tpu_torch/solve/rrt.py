"""RRT-Connect: a sampling-based planner whose collision queries run on the
task's device (counterpart of torch_robotics_tpu/solve/rrt.py).

The tree bookkeeping stays on the host in numpy, written as the reference
writes it (``np.random.RandomState(0)``, ``steer`` on float32 arrays, the
segment points ``a * (1 - w) + b * w`` with float64 ``w``), so that the same
pre-samples give the same path node for node.  Nearest-neighbour lookups go
through the native kd-tree (``native/kdtree.cpp``).  The collision queries
are the task's own: the pre-sampling is one batched
``random_coll_free_q`` on the task's device, and every extend checks its
segment with ``task.compute_collision`` there too.  On the card that is one
small query an extend, which waits for the device; ``stats`` counts and
times those checks.  (The reference checks its segments with the same
function jitted on the host CPU; the port keeps no CPU twin of the task.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["RRTConnectParams", "rrt_connect"]


@dataclasses.dataclass(frozen=True)
class RRTConnectParams:
    n_iters: int = 10000
    step_size: float = 0.01
    n_radius: float = 0.3
    n_pre_samples: int = 50000
    max_time: float = 60.0
    n_collision_points_per_segment: int = 16

    @classmethod
    def from_preset(cls, preset: dict) -> "RRTConnectParams":
        """From a reference-style planner-params dict
        (``EnvBase.get_rrt_connect_params``)."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in preset.items() if k in known}
        kwargs["n_iters"] = int(kwargs.get("n_iters", 10000))
        kwargs["n_pre_samples"] = int(kwargs.get("n_pre_samples", 50000))
        return cls(**kwargs)


def _make_segment_checker(task, n_points: int, stats: dict):
    """Segment collision check on the task's device: ``n_points`` points
    from a to b, free when none collides.  Counts the checks and their
    host seconds into ``stats``."""
    w = np.linspace(0.0, 1.0, n_points)[:, None]

    def segment_free(a, b):
        t0 = time.perf_counter()
        pts = (a[None] * (1 - w) + b[None] * w).astype(np.float32)
        coll = task.compute_collision(torch.as_tensor(pts,
                                                      device=task.device))
        free = not bool(coll.any())
        stats["n_checks"] += 1
        stats["check_s"] += time.perf_counter() - t0
        return free

    return segment_free


def _rrt_connect_from_samples(task, start, goal, samples,
                              params: RRTConnectParams,
                              stats: Optional[dict] = None):
    """The tree loop of ``rrt_connect`` from given collision-free samples
    (n, d) (numpy float32): start and goal (d,) -> (N, d) float32 path or
    None.  ``stats`` (a dict) receives ``n_checks``, ``check_s``,
    ``n_iters`` and ``loop_s``."""
    from ..native import KdTree

    if stats is None:
        stats = {}
    stats.update(n_checks=0, check_s=0.0, n_iters=0, loop_s=0.0)
    start = np.asarray(start, np.float32).reshape(-1)
    goal = np.asarray(goal, np.float32).reshape(-1)
    d = start.shape[0]
    samples = np.asarray(samples, np.float32).reshape(-1, d)
    if len(samples) == 0:
        return None
    segment_free = _make_segment_checker(
        task, params.n_collision_points_per_segment, stats)

    # two trees (nodes, parents, kd-tree): A roots at start, B at goal
    def new_tree(root):
        kt = KdTree(d)
        kt.insert(root)
        return {"nodes": [root], "parents": [-1], "kd": kt}

    trees = [new_tree(start), new_tree(goal)]

    def nearest(tree, q):
        i = tree["kd"].nearest(q)
        return i, tree["nodes"][i]

    def steer(q_near, q_target):
        delta = q_target - q_near
        dist = float(np.linalg.norm(delta))
        if dist <= params.n_radius:
            return q_target
        return q_near + delta / dist * params.n_radius

    def extend(tree, q_target):
        """-> ('reached' | 'advanced' | 'trapped', new node index)."""
        i_near, q_near = nearest(tree, q_target)
        q_new = steer(q_near, q_target)
        if not segment_free(q_near, q_new):
            return "trapped", -1
        tree["nodes"].append(q_new)
        tree["parents"].append(i_near)
        tree["kd"].insert(q_new)
        status = ("reached"
                  if np.linalg.norm(q_new - q_target) < 1e-6 else "advanced")
        return status, len(tree["nodes"]) - 1

    def connect(tree, q_target):
        status, idx = "advanced", -1
        while status == "advanced":
            status, idx = extend(tree, q_target)
        return status, idx

    def path_to_root(tree, idx):
        path = []
        while idx >= 0:
            path.append(tree["nodes"][idx])
            idx = tree["parents"][idx]
        return path[::-1]

    rng = np.random.RandomState(0)
    t_start = time.perf_counter()
    a, b = 0, 1
    path = None
    for it in range(params.n_iters):
        if time.perf_counter() - t_start > params.max_time:
            break
        stats["n_iters"] = it + 1
        q_rand = samples[rng.randint(len(samples))]
        status_a, idx_a = extend(trees[a], q_rand)
        if status_a != "trapped":
            q_new = trees[a]["nodes"][idx_a]
            status_b, idx_b = connect(trees[b], q_new)
            if status_b == "reached":
                path_a = path_to_root(trees[a], idx_a)
                path_b = path_to_root(trees[b], idx_b)
                path = np.asarray(path_a + path_b[::-1] if a == 0
                                  else path_b + path_a[::-1])
                break
        a, b = b, a
    stats["loop_s"] = time.perf_counter() - t_start
    return path


def rrt_connect(task, start_q, goal_q,
                params: Optional[RRTConnectParams] = None,
                generator: Optional[torch.Generator] = None,
                stats: Optional[dict] = None):
    """Plan a collision-free path from start_q to goal_q (d,).

    Pre-samples ``min(n_pre_samples, 8192)`` collision-free configurations
    from ``n_pre_samples`` candidates in one batched query
    (``task.random_coll_free_q`` with ``generator``; None: a generator on
    the task's device seeded 0, as the reference defaults to key 0), then
    grows the two trees.  Returns an (N, d) float32 numpy path, endpoints
    included, or None.  ``stats`` (a dict) receives the tree loop's counts
    and times (``_rrt_connect_from_samples``) and ``sample_s``."""
    if params is None:
        params = RRTConnectParams()
    if generator is None:
        generator = torch.Generator(device=task.device).manual_seed(0)
    if stats is None:
        stats = {}
    start_q, goal_q = (x.detach().cpu().numpy() if torch.is_tensor(x) else x
                       for x in (start_q, goal_q))
    t0 = time.perf_counter()
    samples, n_valid = task.random_coll_free_q(
        generator, n_samples=min(params.n_pre_samples, 8192),
        max_samples=params.n_pre_samples)
    samples = samples.reshape(-1, samples.shape[-1])[:int(n_valid)]
    samples = samples.cpu().numpy()
    sample_s = time.perf_counter() - t0
    path = _rrt_connect_from_samples(task, start_q, goal_q, samples, params,
                                     stats)
    stats["sample_s"] = sample_s
    return path
