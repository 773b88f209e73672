"""PlanningTask: robot + environment -> collision residuals, the 'sdf'
cost, collision checks and trajectory metrics (counterpart of
torch_robotics_tpu/tasks/planning_task.py).

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
are covered; a robot that holds a grasped object has its object's points
in every row and check, through the robot's point selectors.  A robot with
a learned self-collision net (the reference's STORM-style Panda) has the
net's one row in place of the pair rows, and its collision check is the
net's fixed-threshold test.  A scene whose fixed objects are a precomputed
SDF grid (``EnvBase(precompute_sdf_obj_fixed=True)``) takes the grid in
their place in every row and check; with ``use_occupancy_map`` the
collision check reads the scene's occupancy map instead of the distance
fields.  A robot with no lanes path (the planar 2-link arm: no kinematic
model, interpolated points) gets no lanes terms and no lanes cost, as in
the reference: its residuals and their Jacobians come from
``fk_map_collision_with_jac``, and the GN solvers take their generic step
for it.
The 'sdf' cost (``_compute_cost``, ``compute_collision_cost``) sums the
self-collision (or net), object and workspace costs of ``costs/fields.py``
per configuration, each relu-clamped where the task is built with
``clamp_sdf_cost``; it is plain PyTorch on every device, as it is plain XLA
in the reference, and autograd differentiates it (MPOT's clearance step).
The 'rbf' cost is the Gaussian surrogate of the object and self fields;
the scene's extra (movable) objects have a cost of their own
(``compute_collision_cost_extra_objects``), and are also in the object
list of every other row.  The tail a planning script reaches last splits
a batch of trajectories into colliding and free ones and scores it
(``get_trajs_collision_and_free``, ``compute_fraction_free_trajs``,
``compute_collision_intensity_trajs``, ``compute_success_free_trajs``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import disable_tf32
from ..costs.fields import (object_collision_any, object_collision_cost,
                            object_collision_rbf, self_collision_any,
                            self_collision_cost, self_collision_rbf,
                            workspace_bounds_any, workspace_bounds_cost)
from ..trajectory.utils import interpolate_traj_via_points

__all__ = ["PlanningTask", "CollisionResiduals"]


class CollisionResiduals:
    """Per-waypoint hinge collision residuals of a task.

    Calling it maps q (..., d) to the residuals (..., P): one
    relu(margin + cutoff - min-object-SDF) row per object point, one
    relu(margin + cutoff - min-face distance) row per object point, one
    relu(margin - pair distance) row per self-collision pair, in that
    order; with a learned self-collision net, no pair rows and a last row
    relu(``PlanningTask._NET_SELF_CUTOFF`` - sd(q)).  Attributes, as the
    reference's residual function carries them:

    - ``supports_batch``: True, one call takes the whole flattened batch;
    - ``residuals_and_jacobian(q) -> (r (..., P), J (..., P, d))``, rows in
      the same order, analytic Jacobians (plain PyTorch);
    - ``obstacle_terms_lanes(q_cols (d, N), lam, h=None) -> (g, Hb, cost)``,
      the GN terms (terms kernel); None for a robot with no lanes path (the
      planar 2-link arm), whose GN step is the generic one;
    - ``collision_cost_lanes(q_cols (d, N)) -> (N,)``, the unscaled cost
      0.5 sum r^2 (value-only cost kernel, its MultiRobot variant for a
      ``MultiRobot``); None for a point mass and a robot with no lanes
      path, which have no such kernel (solvers then score with the
      residual values).

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
        # the plain lanes terms (the point mass), else none (generic rows)
        self.obstacle_terms_lanes = (obstacle_terms_kernel_factory(task)
                                     or obstacle_terms_lanes_factory(task))
        self.collision_cost_lanes = None
        if self.obstacle_terms_lanes is None:
            rows = _GenericLayout(task).rows
        else:
            self.collision_cost_lanes = collision_cost_kernel_factory(
                task, self.obstacle_terms_lanes)
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


class _GenericLayout:
    """The residual rows of a robot with no lanes path, from its
    ``fk_map_collision_with_jac`` through ``ops/lanes_fk.hinge_rows``: the
    object collision points (interpolated where the robot says so, then
    any grasped points), then its self-collision points.  Rows in the
    order of ``CollisionResiduals``."""

    def __init__(self, task):
        robot = task.robot
        self.robot = robot
        self.net = getattr(robot, "self_collision_net", None)
        self.net_cutoff = (None if self.net is None
                           else float(task._NET_SELF_CUTOFF))
        self.obj_thresh = (robot.object_margins
                           + float(task.obstacle_cutoff_margin))
        n_obj = self.obj_thresh.shape[0]
        self.obj_pos = list(range(n_obj))
        pairs = np.asarray(robot.self_pair_idxs if self.net is None else (),
                           np.int64).reshape(-1, 2)
        self.pair_a = [n_obj + int(a) for a in pairs[:, 0]]
        self.pair_b = [n_obj + int(b) for b in pairs[:, 1]]
        self.self_margins = (robot.self_margins[:len(pairs)] if len(pairs)
                             else None)
        self.ws_min = task.ws_min
        self.ws_max = task.ws_max
        self.df_obj_list = task.df_obj_list

    def rows(self, q_cols):
        """q_cols (d, N) -> (r (R, N), Jr (R, d, N)), the analytic rows."""
        from ..ops.lanes_fk import hinge_rows
        robot = self.robot
        q = q_cols.T
        pts_full, J_full = robot.fk_map_collision_with_jac(q)
        pts = [robot.object_collision_points(pts_full)]
        Js = [robot.select_collision_jacobians(
            J_full, robot.object_coll_idxs, robot.object_interpolate,
            robot.object_num_interp)]
        if self.pair_a:
            pts.append(robot.self_collision_points(pts_full))
            Js.append(robot.select_collision_jacobians(
                J_full, robot.self_coll_idxs))
        pts = torch.cat(pts, dim=-2).permute(1, 2, 0)          # (P, ws, N)
        J = torch.cat(Js, dim=-3).permute(1, 3, 2, 0)          # (P, d, ws, N)
        return hinge_rows(self, pts, J, q_cols)


class PlanningTask:
    # the reference's self-collision fields use their own cutoff margin;
    # the net's hinge row is built with it
    _NET_SELF_CUTOFF = 0.001
    # occupancy threshold of the learned net (trained at 0.02)
    _NET_SELF_COLL_THRESHOLD = -0.05

    def __init__(self, env=None, robot=None, ws_limits=None,
                 use_occupancy_map: bool = False, cell_size: float = 0.01,
                 obstacle_cutoff_margin: float = 0.01,
                 clamp_sdf_cost: bool = False):
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
        self.clamp_sdf_cost = clamp_sdf_cost
        self.use_occupancy_map = use_occupancy_map
        if use_occupancy_map:
            env.build_occupancy_map(cell_size=cell_size)
        self.df_obj_list = env.get_df_obj_list()
        self.df_extra_list = (
            env.get_df_obj_list(return_extra_objects_only=True)
            if env.obj_extra_list is not None else [])
        self.collision_residuals = CollisionResiduals(self)

    @property
    def self_collision_net(self):
        return getattr(self.robot, "self_collision_net", None)

    # ------------------------------------------------------------------
    # the 'sdf' cost
    # ------------------------------------------------------------------
    def _compute_cost(self, q):
        """'sdf' cost per configuration: q (..., d) -> (...), the
        self-collision (or learned net) cost, then the object cost, then
        the workspace cost, each clamped with ``clamp_sdf_cost``."""
        link_pos = self.robot.fk_map_collision(q)
        obj_pts = self.robot.object_collision_points(link_pos)
        self_pts = self.robot.self_collision_points(link_pos)
        clamp = self.clamp_sdf_cost
        terms = []
        net = self.self_collision_net
        if net is not None:
            c = self._NET_SELF_CUTOFF - net.signed_distance(q)
            terms.append(torch.relu(c) if clamp else c)
        elif self_pts is not None:
            terms.append(self_collision_cost(
                self_pts, np.asarray(self.robot.self_pair_idxs),
                self.robot.self_margins, clamp=clamp))
        if self.df_obj_list:
            terms.append(object_collision_cost(
                self.df_obj_list, obj_pts, self.robot.object_margins,
                cutoff_margin=self.obstacle_cutoff_margin, clamp=clamp))
        terms.append(workspace_bounds_cost(
            obj_pts, self.ws_min, self.ws_max, self.robot.object_margins,
            cutoff_margin=self.obstacle_cutoff_margin, clamp=clamp))
        cost = terms[0]
        for t in terms[1:]:
            cost = cost + t
        return cost

    def compute_collision_cost(self, x, field_type: str = "sdf"):
        """x (..., d_state) -> per-waypoint cost (...): 'sdf' (the cost
        above), 'rbf' (``compute_collision_cost_rbf`` at the cutoff
        margin) or 'occupancy' (the collision check as a float)."""
        if field_type == "sdf":
            return self._compute_cost(self.robot.get_position(x))
        if field_type == "rbf":
            return self.compute_collision_cost_rbf(x)
        if field_type == "occupancy":
            return self.compute_collision(x).to(x.dtype)
        raise NotImplementedError(f"field_type {field_type}")

    def _collision_points(self, q):
        link_pos = self.robot.fk_map_collision(q)
        return (self.robot.object_collision_points(link_pos),
                self.robot.self_collision_points(link_pos))

    def compute_collision_cost_rbf(self, x, margin: Optional[float] = None):
        """'rbf' cost per waypoint (...): the object field's Gaussians of
        the object SDFs plus, for a robot with self-collision points, the
        full pairwise Gaussian matrix of those points; ``margin`` defaults
        to the task's cutoff margin."""
        m = self.obstacle_cutoff_margin if margin is None else margin
        q = self.robot.get_position(x)
        obj_pts, self_pts = self._collision_points(q)
        cost = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
        if self.df_obj_list:
            cost = cost + object_collision_rbf(self.df_obj_list, obj_pts, m)
        if self_pts is not None:
            cost = cost + self_collision_rbf(self_pts, m)
        return cost

    def compute_collision_cost_extra_objects(self, x):
        """The 'sdf' object cost against the extra (movable) objects alone
        (zero without any): x (..., d_state) -> (...)."""
        if not self.df_extra_list:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        obj_pts, _ = self._collision_points(self.robot.get_position(x))
        return object_collision_cost(
            self.df_extra_list, obj_pts, self.robot.object_margins,
            cutoff_margin=self.obstacle_cutoff_margin,
            clamp=self.clamp_sdf_cost)

    def get_collision_fields(self):
        """The fields behind the task's cost terms: the self-collision
        pairs (numpy (K, 2), None for a robot without), the object list
        and the workspace bounds."""
        pairs = self.robot.self_pair_idxs
        return {"self": np.asarray(pairs) if len(pairs) else None,
                "objects": self.df_obj_list,
                "ws_bounds": (self.ws_min, self.ws_max)}

    def get_collision_fields_extra_objects(self):
        return self.df_extra_list

    # ------------------------------------------------------------------
    # collision checks
    # ------------------------------------------------------------------
    def _compute_collision(self, q, margin_override: Optional[float] = None):
        """'occupancy' check: q (..., d) -> bool (...).  With
        ``margin_override`` every margin is that value and the cutoff 0; a
        learned self-collision net's test keeps its fixed threshold."""
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
        net = self.self_collision_net
        if net is not None:
            coll = coll | net.collision(q, self._NET_SELF_COLL_THRESHOLD)
        elif self_pts is not None:
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
        """x: (..., d_state) states -> per-waypoint collision flags (...):
        the occupancy check with ``use_occupancy_map`` (``margin`` then
        unused), else the distance-field check."""
        q = self.robot.get_position(x)
        if self.use_occupancy_map:
            return self._compute_collision_occupancy(q)
        return self._compute_collision(q, margin_override=margin)

    def _compute_collision_occupancy(self, q):
        """Occupancy check: q (..., d) -> bool (...), True where q leaves
        the joint limits, an object collision point leaves the workspace,
        or a point's occupancy cell is occupied."""
        out_of_limits = ((q < self.robot.q_min)
                         | (q > self.robot.q_max)).any(-1)
        pts = self.robot.object_collision_points(
            self.robot.fk_map_collision(q))
        out_of_ws = ((pts < self.ws_min) | (pts > self.ws_max)).flatten(
            -2).any(-1)
        hit = (self.env.occupancy_map.get_collisions(pts) > 0).any(-1)
        return out_of_limits | out_of_ws | hit

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sample_q(self, generator: torch.Generator,
                 without_collision: bool = True, **kwargs):
        """``random_coll_free_q`` (-> (samples, n_valid)), or without
        ``without_collision`` the robot's uniform ``random_q``."""
        if without_collision:
            return self.random_coll_free_q(generator, **kwargs)
        return self.robot.random_q(generator, **kwargs)

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

    def get_trajs_collision_and_free(self, trajs, return_indices=False,
                                     num_interpolation: int = 5):
        """Split trajs (..., H, D), flattened to (N, H, D), into the
        colliding and the free ones (``trajs_collision_masks``): ->
        (trajs_coll, trajs_free), each None where empty; with
        ``return_indices`` (trajs_coll, coll_idxs, trajs_free, free_idxs,
        waypoint_colls), the indices int64 tensors into the flattened
        batch."""
        coll_mask, waypoint_colls = self.trajs_collision_masks(
            trajs, num_interpolation)
        coll_mask = coll_mask.reshape(-1)
        flat = trajs.reshape((-1,) + tuple(trajs.shape[-2:]))
        coll_idxs = torch.nonzero(coll_mask).flatten()
        free_idxs = torch.nonzero(~coll_mask).flatten()
        trajs_coll = flat[coll_idxs] if len(coll_idxs) else None
        trajs_free = flat[free_idxs] if len(free_idxs) else None
        if return_indices:
            return (trajs_coll, coll_idxs, trajs_free, free_idxs,
                    waypoint_colls)
        return trajs_coll, trajs_free

    def compute_fraction_free_trajs(self, trajs, **kwargs):
        coll_mask, _ = self.trajs_collision_masks(trajs, **kwargs)
        return float((~coll_mask).float().mean())

    def compute_collision_intensity_trajs(self, trajs, **kwargs):
        """The share of interpolated waypoints in collision."""
        _, waypoint_colls = self.trajs_collision_masks(trajs, **kwargs)
        return float(waypoint_colls.float().mean())

    def compute_success_free_trajs(self, trajs, **kwargs):
        """1 if any trajectory is free, else 0."""
        coll_mask, _ = self.trajs_collision_masks(trajs, **kwargs)
        return int((~coll_mask).any())

    def distance_q(self, q1, q2):
        return self.robot.distance_q(q1, q2)
