"""Hybrid planning: a global stage + gradient refinement (counterpart of
torch_robotics_tpu/solve/hybrid.py).

``plan_hybrid``: RRT-Connect finds a coarse collision-free path, the
clamped cubic spline resamples it onto the support points, and batched
GPMP2 refines jittered copies of that seed.  On the card the refinement
runs the GN terms and the block-tridiagonal sweep of ``gpmp2_solve``; the
RRT's queries run on the task's device (``solve/rrt.py``).

``plan_mpot_gpmp2``: MPOT's Sinkhorn steps route the whole ensemble around
the obstacles (``solve/mpot.py``, plain tensor ops), then a short GPMP2
polish; trajectories the polish leaves in collision are also polished from
the original init, and the better of the two is kept per trajectory.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..trajectory.utils import smoothen_trajectory
from .gp_prior import straight_line_trajs
from .gpmp2 import GPMP2Params, GPMP2Result, gpmp2_solve
from .rrt import RRTConnectParams, rrt_connect

__all__ = ["plan_hybrid", "plan_mpot_gpmp2"]


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def plan_mpot_gpmp2(task, theta0, start_state, goal_state,
                    mpot_params=None,
                    gpmp2_params: Optional[GPMP2Params] = None,
                    polish_iters: int = 50,
                    generator: Optional[torch.Generator] = None,
                    fallback_polish: bool = True,
                    stats: Optional[dict] = None):
    """Sinkhorn-step exploration + Gauss-Newton polish.

    theta0 (..., H, 2d), start_state and goal_state (2d,).  MPOT
    (``mpot_solve``, its rotations from ``generator``) runs on the task's
    'sdf' cost, its guard and clearance passes on the clamped cost of a
    second task (``clamp_sdf_cost``); then ``polish_iters`` GPMP2
    iterations of ``gpmp2_params`` (default: the scene's presets for both
    stages).  With ``fallback_polish``, where a polished trajectory is not
    free, theta0 is polished too and its result taken where only it is
    free.  -> (GPMP2Result, MPOTResult); the result's cost trace is the
    first polish's.  ``stats`` (a dict) receives each stage's wall seconds
    (``mpot_s``, ``polish_s``, ``fallback_s``; the device is synchronised
    at each stage's end for them) and ``fallback_ran``."""
    from ..tasks import PlanningTask
    from .mpot import MPOTParams, mpot_solve

    if mpot_params is None:
        mpot_params = MPOTParams.from_preset(
            task.env.get_mpot_params(task.robot))
    if gpmp2_params is None:
        gpmp2_params = GPMP2Params.from_preset(
            task.env.get_gpmp2_params(task.robot))
    d = task.robot.q_dim
    task_h = PlanningTask(env=task.env, robot=task.robot,
                          obstacle_cutoff_margin=task.obstacle_cutoff_margin,
                          clamp_sdf_cost=True)

    def state_cost(theta):
        return task._compute_cost(theta[..., :d])

    def hinge_cost(theta):
        return task_h._compute_cost(theta[..., :d])

    def lap(key, t0):
        if stats is not None:
            _sync(theta0.device)
            stats[key] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    res_mpot = mpot_solve(state_cost, theta0, start_state, goal_state,
                          mpot_params, generator=generator,
                          hinge_cost_fn=hinge_cost)
    t0 = lap("mpot_s", t0)
    polish = dataclasses.replace(gpmp2_params, opt_iters=polish_iters)
    result = gpmp2_solve(task.collision_residuals, res_mpot.trajs,
                         start_state, goal_state, polish)
    t0 = lap("polish_s", t0)
    ran = False
    if fallback_polish:
        free = ~task.trajs_collision_masks(result.trajs[..., :d])[0]
        if not bool(free.all()):
            ran = True
            res_fb = gpmp2_solve(task.collision_residuals, theta0,
                                 start_state, goal_state, polish)
            free_fb = ~task.trajs_collision_masks(res_fb.trajs[..., :d])[0]
            # the pipeline's result where it is free (or neither is); the
            # fallback's where only it is free
            take_fb = free_fb & ~free
            result = GPMP2Result(
                trajs=torch.where(take_fb[..., None, None], res_fb.trajs,
                                  result.trajs),
                costs=torch.where(take_fb, res_fb.costs, result.costs),
                cost_trace=result.cost_trace)
    lap("fallback_s", t0)
    if stats is not None:
        stats["fallback_ran"] = ran
    return result, res_mpot
