"""PlanningTask: robot + environment -> collision residuals, collision
checks and trajectory metrics (counterpart of
torch_robotics_tpu/tasks/planning_task.py, as far as the GPMP2 and iLQR
paths need it).

The task composes the collision rows (objects, workspace bounds,
self-collision pairs) of the robot in the scene.  Its lanes terms and its
value-only lanes cost come from the CUDA kernels' wrappers, which take the
kernel for CUDA tensors and the plain PyTorch version for CPU tensors.  A
point mass has no fused kernel, in the JAX package as here (its fused
factories return None there too): its lanes terms are the plain lanes
terms on every device, and it has no value-only lanes cost.
Residual values and Jacobians, the collision checks and the metrics are
plain PyTorch on every device, as they are plain XLA in the reference.
Single kinematic robots, ``MultiRobot``s (several arms at fixed base
poses, with mutual-collision pairs) and point masses in 2-D or 3-D scenes
are covered.
Occupancy maps and the learned self-collision net are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import disable_tf32
from ..costs.fields import (object_collision_any, self_collision_any,
                            workspace_bounds_any)
from ..trajectory.utils import interpolate_traj_via_points

__all__ = ["PlanningTask", "CollisionResiduals"]


class CollisionResiduals:
    """Per-waypoint hinge collision residuals of a task.

    Calling it maps q (..., d) to the residuals (..., P): one
    relu(margin + cutoff - min-object-SDF) row per object point, one
    relu(margin + cutoff - min-face distance) row per object point, one
    relu(margin - pair distance) row per self-collision pair, in that
    order.  Attributes, as the reference's residual function carries them:

    - ``supports_batch``: True, one call takes the whole flattened batch;
    - ``residuals_and_jacobian(q) -> (r (..., P), J (..., P, d))``, rows in
      the same order, analytic Jacobians (plain PyTorch);
    - ``obstacle_terms_lanes(q_cols (d, N), lam, h=None) -> (g, Hb, cost)``,
      the GN terms (terms kernel);
    - ``collision_cost_lanes(q_cols (d, N)) -> (N,)``, the unscaled cost
      0.5 sum r^2 (value-only cost kernel, its MultiRobot variant for a
      ``MultiRobot``); None for a point mass, which has no such kernel
      (solvers then score with the residual values).

    For a ``MultiRobot`` the rows run over its full collision layout:
    object rows of every member's object points, workspace rows, then the
    own and mutual pairs as ``self_pair_idxs`` lists them.
    """
    supports_batch = True

    def __init__(self, task):
        from ..ops.lanes_fk import obstacle_terms_lanes_factory
        from ..ops.terms_kernel import (collision_cost_kernel_factory,
                                        obstacle_terms_kernel_factory)
        # the reference's routing: the fused kernel where one exists, else
        # the plain lanes terms (the point mass)
        self.obstacle_terms_lanes = (obstacle_terms_kernel_factory(task)
                                     or obstacle_terms_lanes_factory(task))
        self.collision_cost_lanes = collision_cost_kernel_factory(
            task, self.obstacle_terms_lanes)
        if self.obstacle_terms_lanes is None:
            raise NotImplementedError(
                "collision residuals need a kinematic model whose collision "
                "points are link origins, or a point mass")
        rows = getattr(self.obstacle_terms_lanes, "plain",
                       self.obstacle_terms_lanes).rows

        def residuals_and_jacobian(q):
            """q (..., d) -> (r (..., P), J (..., P, d))."""
            batch, d = q.shape[:-1], q.shape[-1]
            r, Jr = rows(q.reshape(-1, d).T)            # (P, N), (P, d, N)
            P = r.shape[0]
            return (r.T.reshape(batch + (P,)),
                    Jr.permute(2, 0, 1).reshape(batch + (P, d)))

        residuals_and_jacobian.supports_batch = True
        self.residuals_and_jacobian = residuals_and_jacobian
        self._rows = rows

    def __call__(self, q):
        """q (..., d) -> residuals (..., P)."""
        batch, d = q.shape[:-1], q.shape[-1]
        r = self._rows(q.reshape(-1, d).T)[0]
        return r.T.reshape(batch + (r.shape[0],))


class PlanningTask:
    def __init__(self, env=None, robot=None, ws_limits=None,
                 use_occupancy_map: bool = False,
                 obstacle_cutoff_margin: float = 0.01):
        if use_occupancy_map:
            raise NotImplementedError("occupancy maps are not ported yet")
        # GN systems NaN under TF32 products (core/device.py)
        disable_tf32()
        self.env = env
        self.robot = robot
        self.device = robot.device
        limits = env.limits if ws_limits is None else torch.as_tensor(
            np.asarray(ws_limits, np.float64), dtype=torch.float32,
            device=self.device)
        self.ws_limits = limits
        self.ws_min = limits[0]
        self.ws_max = limits[1]
        self.obstacle_cutoff_margin = obstacle_cutoff_margin
        self.df_obj_list = env.get_df_obj_list()
        self.collision_residuals = CollisionResiduals(self)

    # ------------------------------------------------------------------
    # collision checks
    # ------------------------------------------------------------------
    def _compute_collision(self, q, margin_override: Optional[float] = None):
        """'occupancy' check: q (..., d) -> bool (...).  With
        ``margin_override`` every margin is that value and the cutoff 0."""
        if getattr(self.robot, "self_collision_net", None) is not None:
            raise NotImplementedError(
                "the learned self-collision net is not ported yet")
        link_pos = self.robot.fk_map_collision(q)
        obj_pts = self.robot.object_collision_points(link_pos)
        self_pts = self.robot.self_collision_points(link_pos)
        if margin_override is None:
            obj_margins = self.robot.object_margins
            cutoff = self.obstacle_cutoff_margin
            self_margins = (self.robot.self_margins
                            if self_pts is not None else None)
        else:
            obj_margins = self_margins = margin_override
            cutoff = 0.0
        coll = torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
        if self_pts is not None:
            coll = coll | self_collision_any(
                self_pts, np.asarray(self.robot.self_pair_idxs),
                self_margins)
        if self.df_obj_list:
            coll = coll | object_collision_any(
                self.df_obj_list, obj_pts, obj_margins, cutoff_margin=cutoff)
        return coll | workspace_bounds_any(
            obj_pts, self.ws_min, self.ws_max, obj_margins,
            cutoff_margin=cutoff)

    def compute_collision(self, x, margin=None):
        """x: (..., d_state) states -> per-waypoint collision flags (...)."""
        return self._compute_collision(self.robot.get_position(x),
                                       margin_override=margin)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def random_coll_free_q(self, generator: torch.Generator,
                           n_samples: int = 1, max_samples: int = 1000):
        """Fixed-budget rejection sampling: draws ``max_samples``
        candidates, returns the first ``n_samples`` collision-free ones
        (index 0 fills the rest) and how many were found (at most
        ``n_samples``; callers check it)."""
        qs = self.robot.random_q(generator, max_samples)
        free = torch.nonzero(~self._compute_collision(qs)).flatten()
        n_valid = min(int(free.numel()), n_samples)
        idx = torch.zeros(n_samples, dtype=torch.long, device=qs.device)
        idx[:n_valid] = free[:n_valid]
        samples = qs[idx]
        return (samples[0] if n_samples == 1 else samples), n_valid

    # ------------------------------------------------------------------
    # trajectory metrics
    # ------------------------------------------------------------------
    def trajs_collision_masks(self, trajs, num_interpolation: int = 5):
        """trajs (..., H, D) -> (traj_in_collision (...), waypoint_colls
        (..., (H - 1) num_interpolation)).  A trajectory is free iff no
        interpolated waypoint collides (margins 0) and every support
        position is inside the joint limits."""
        trajs_pos = self.robot.get_position(trajs)
        interp = interpolate_traj_via_points(trajs_pos, num_interpolation)
        waypoint_colls = self._compute_collision(interp, margin_override=0.0)
        in_limits = ((trajs_pos >= self.robot.q_min)
                     & (trajs_pos <= self.robot.q_max)).flatten(-2).all(-1)
        return waypoint_colls.any(-1) | ~in_limits, waypoint_colls

    def compute_fraction_free_trajs(self, trajs, **kwargs):
        coll_mask, _ = self.trajs_collision_masks(trajs, **kwargs)
        return float((~coll_mask).float().mean())

    def distance_q(self, q1, q2):
        return self.robot.distance_q(q1, q2)
