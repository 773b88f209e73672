"""Hybrid planning: sampling-based seed + gradient refinement (counterpart
of torch_robotics_tpu/solve/hybrid.py, its ``plan_hybrid``).

RRT-Connect finds a coarse collision-free path, the clamped cubic spline
resamples it onto the support points, and batched GPMP2 refines jittered
copies of that seed.  On the card the refinement runs the GN terms and
the block-tridiagonal sweep of ``gpmp2_solve``; the RRT's queries run on
the task's device (``solve/rrt.py``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..trajectory.utils import smoothen_trajectory
from .gp_prior import straight_line_trajs
from .gpmp2 import GPMP2Params, gpmp2_solve
from .rrt import RRTConnectParams, rrt_connect

__all__ = ["plan_hybrid"]


def _hybrid_seed(path, start_q, goal_q, H: int, dt: float, normals,
                 noise_scale: float):
    """The refinement batch: the RRT path (N, d) resampled by the spline
    with the average velocity, or the straight line when path is None, plus
    ``normals`` (n, H, 2d) x ``noise_scale`` x a ramp that is 0 at both
    ends -> theta0 (n, H, 2d)."""
    d = start_q.shape[-1]
    if path is not None:
        pos, vel = smoothen_trajectory(
            torch.as_tensor(np.asarray(path), device=start_q.device),
            n_support_points=H, dt=dt, set_average_velocity=True)
        theta_init = torch.cat([pos, vel], dim=-1)
    else:
        zeros = torch.zeros_like(start_q)
        theta_init = straight_line_trajs(torch.cat([start_q, zeros]),
                                         torch.cat([goal_q, zeros]), H)
    kw = dict(dtype=theta_init.dtype, device=theta_init.device)
    noise = normals.to(**kw) * noise_scale
    ramp = torch.minimum(torch.linspace(0, 1, H, **kw),
                         torch.linspace(1, 0, H, **kw))
    return theta_init[None] + noise * ramp[:, None]


def plan_hybrid(task, start_q, goal_q,
                gpmp2_params: Optional[GPMP2Params] = None,
                rrt_params: Optional[RRTConnectParams] = None,
                num_samples: int = 8, noise_scale: float = 0.02,
                generator: Optional[torch.Generator] = None,
                stats: Optional[dict] = None):
    """RRT-Connect -> spline smoothing -> batched GPMP2 refinement.

    start_q, goal_q (d,).  The presets default to the scene's (an RRT
    preset only where the scene has one for the robot, else
    ``RRTConnectParams()``).  ``generator`` (None: one on the task's device
    seeded 0) draws the RRT's pre-samples and then the seed's jitter.
    Returns (GPMP2Result, rrt path (N, d) numpy or None); if RRT fails the
    refinement starts from the straight line.  ``stats`` (a dict) receives
    the RRT's (``rrt_connect``) and ``rrt_s``, its wall seconds."""
    if gpmp2_params is None:
        gpmp2_params = GPMP2Params.from_preset(
            task.env.get_gpmp2_params(task.robot))
    if rrt_params is None:
        rrt_params = (RRTConnectParams.from_preset(
            task.env.get_rrt_connect_params(task.robot))
            if task.env.has_preset("rrt_connect", task.robot)
            else RRTConnectParams())
    if generator is None:
        generator = torch.Generator(device=task.device).manual_seed(0)
    if stats is None:
        stats = {}
    start_q = torch.as_tensor(start_q, device=task.device)
    goal_q = torch.as_tensor(goal_q, device=task.device)
    d = start_q.shape[-1]
    H = gpmp2_params.n_support_points

    t0 = time.perf_counter()
    path = rrt_connect(task, start_q, goal_q, rrt_params,
                       generator=generator, stats=stats)
    stats["rrt_s"] = time.perf_counter() - t0
    normals = torch.randn((num_samples, H, 2 * d), generator=generator,
                          dtype=start_q.dtype, device=generator.device)
    theta0 = _hybrid_seed(path, start_q, goal_q, H, gpmp2_params.dt,
                          normals.to(task.device), noise_scale)
    zeros = torch.zeros_like(start_q)
    result = gpmp2_solve(task.collision_residuals, theta0,
                         torch.cat([start_q, zeros]),
                         torch.cat([goal_q, zeros]), gpmp2_params)
    return result, path
