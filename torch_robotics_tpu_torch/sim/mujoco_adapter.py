"""MuJoCo execution adapter: physics validation of planned trajectories
(counterpart of torch_robotics_tpu/sim/mujoco_adapter.py).

Planned joint trajectories are executed on a PD position-servo robot
model while MuJoCo's own collision detection and contact dynamics decide
whether the robot touches the environment: a check that "collision-free"
does not merely mean "agrees with the planner's SDF" (the PD harness in
``sim/rollout.py`` reuses the task's collision model).

The robot model is built from the compiled ``KinematicModel`` (joint
frames, axes, limits) with the per-link collision spheres of
``data/configs/<robot>/*_sphere_config.yaml``; the environment's obstacles
become static geoms.  Robot geoms collide with obstacles only
(contype / conaffinity): self-collision is the task's pair and net rows'
business, the physics check targets environment contact.

MuJoCo is a host engine: the model is built from host copies of the
robot's and the scene's tensors, and trajectories (tensors on any device
or arrays) are copied to the host to run.  ``mujoco`` is imported inside
the functions that use it, so this module imports where it is missing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.utils import to_numpy
from ..kin.model import (JOINT_CONTINUOUS, JOINT_FIXED, JOINT_PRISMATIC,
                         KinematicModel)

__all__ = ["MujocoExecutionEnv", "MujocoExecutionResult", "build_mj_spec",
           "panda_sphere_model"]

_ROBOT_CONTYPE = 1
_OBSTACLE_CONTYPE = 2


def _rot_to_quat(R):
    """A rotation matrix -> its unit wxyz quaternion (float64 numpy),
    converted in float32 by ``core/quaternion.rotation_matrix_to_q``."""
    from ..core.quaternion import rotation_matrix_to_q
    q = to_numpy(rotation_matrix_to_q(torch.as_tensor(to_numpy(R))),
                 np.float64)
    n = np.linalg.norm(q)
    return q / (n if n > 0 else 1.0)


def _rotation(quat):
    """A wxyz quaternion -> its rotation matrix (float64 numpy), formed in
    float32 by ``core/quaternion.q_to_rotation_matrix``."""
    from ..core.quaternion import q_to_rotation_matrix
    return to_numpy(q_to_rotation_matrix(torch.as_tensor(to_numpy(quat))),
                    np.float64)


def panda_sphere_model() -> dict:
    """Per-link collision spheres [x, y, z, r] of the Panda from the
    bundled yaml."""
    from ..utils.files import get_configs_path, load_yaml
    return load_yaml(get_configs_path() / "panda" /
                     "panda_sphere_config.yaml")


def build_mj_spec(model: KinematicModel, sphere_model: Optional[dict] = None,
                  obstacles: Sequence = (), timestep: float = 0.002,
                  kp: float = 300.0, kd: float = 20.0):
    """Compile a KinematicModel's tree and the obstacles into an MjSpec ->
    (spec, joint names, model dof of each MuJoCo qpos slot): one hinge or
    slide joint per controlled dof in topological order, a position servo
    per joint, the collision spheres of each link."""
    import mujoco

    spec = mujoco.MjSpec()
    spec.compiler.degree = False     # joint ranges are radians
    spec.option.timestep = timestep
    spec.option.gravity = [0.0, 0.0, -9.81]
    # the servos' damping (biasprm kd) is integrated implicitly only by the
    # implicit integrators; explicit Euler blows up at kd ~ 20 on the small
    # link inertias here
    spec.option.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST

    sphere_model = sphere_model or {}
    q_map, c = [], 0                 # the model dof of each link
    for t in model.joint_types:
        q_map.append(c if t != JOINT_FIXED else -1)
        if t != JOINT_FIXED:
            c += 1
    bodies, joint_names, dof_order = {}, [], []
    for i in model.topological_order():
        name = model.link_names[i]
        p = int(model.parent_idx[i])
        parent = spec.worldbody if p < 0 else bodies[p]
        body = parent.add_body(
            name=name,
            pos=np.asarray(model.joint_trans[i], np.float64).tolist(),
            quat=_rot_to_quat(model.joint_fixed_rot[i]).tolist())
        bodies[i] = body

        jtype = model.joint_types[i]
        if jtype != JOINT_FIXED:
            jname = f"joint_{name}"
            kind = (mujoco.mjtJoint.mjJNT_SLIDE if jtype == JOINT_PRISMATIC
                    else mujoco.mjtJoint.mjJNT_HINGE)
            joint = body.add_joint(
                name=jname, type=kind,
                axis=np.asarray(model.joint_axis[i], np.float64).tolist(),
                damping=1.0, armature=0.1)
            lo, hi = float(model.clamp_lower[i]), float(model.clamp_upper[i])
            if jtype != JOINT_CONTINUOUS and np.isfinite([lo, hi]).all() \
                    and abs(lo) < 1e6 and abs(hi) < 1e6:
                joint.range = [lo, hi]
            joint_names.append(jname)
            dof_order.append(q_map[i])

        spheres = sphere_model.get(name, [])
        for s_idx, (x, y, z, r) in enumerate(spheres):
            body.add_geom(
                name=f"{name}_sphere_{s_idx}",
                type=mujoco.mjtGeom.mjGEOM_SPHERE,
                size=[float(r), 0.0, 0.0], pos=[float(x), float(y), float(z)],
                contype=_ROBOT_CONTYPE, conaffinity=_OBSTACLE_CONTYPE,
                density=500.0)
        if not spheres:
            # a jointed body needs mass: a small sphere that collides with
            # nothing gives it inertia
            body.add_geom(
                name=f"{name}_inertial",
                type=mujoco.mjtGeom.mjGEOM_SPHERE,
                size=[0.03, 0.0, 0.0], contype=0, conaffinity=0,
                density=500.0)

    for jname in joint_names:
        # position servo: force = kp (ctrl - qpos) - kd qvel.  biastype must
        # be AFFINE: MjSpec's default, NONE, ignores biasprm (no position
        # feedback at all)
        spec.add_actuator(
            name=f"servo_{jname}", target=jname,
            trntype=mujoco.mjtTrn.mjTRN_JOINT,
            gaintype=mujoco.mjtGain.mjGAIN_FIXED,
            biastype=mujoco.mjtBias.mjBIAS_AFFINE,
            gainprm=[kp] + [0.0] * 9,
            biasprm=[0.0, -kp, -kd] + [0.0] * 7)

    _add_obstacle_geoms(spec, obstacles)
    return spec, joint_names, dof_order


def _add_obstacle_geoms(spec, obstacles):
    """Static geoms of the 3-D ObjectFields' spheres and boxes (a grid has
    no analytic geoms and adds none)."""
    import mujoco

    from ..geom.sdf import ObjectField, RoundedBoxes, SharpBoxes, Spheres
    n = 0
    for obj in obstacles:
        if not isinstance(obj, ObjectField):
            continue
        pos_o = to_numpy(obj.pos, np.float64)
        quat_o = to_numpy(obj.ori, np.float64)
        Rm = _rotation(obj.ori)
        for field in obj.fields:
            centers = to_numpy(field.centers, np.float64)
            if centers.shape[-1] != 3:
                raise ValueError("MuJoCo adapter requires 3-D environments")
            for k in range(centers.shape[0]):
                c_w = Rm @ centers[k] + pos_o    # the object's pose
                if isinstance(field, Spheres):
                    spec.worldbody.add_geom(
                        name=f"obstacle_{n}",
                        type=mujoco.mjtGeom.mjGEOM_SPHERE,
                        size=[float(field.radii[k]), 0.0, 0.0],
                        pos=c_w.tolist(), contype=_OBSTACLE_CONTYPE,
                        conaffinity=_ROBOT_CONTYPE)
                elif isinstance(field, (SharpBoxes, RoundedBoxes)):
                    spec.worldbody.add_geom(
                        name=f"obstacle_{n}",
                        type=mujoco.mjtGeom.mjGEOM_BOX,
                        size=to_numpy(field.half_sizes[k],
                                      np.float64).tolist(),
                        pos=c_w.tolist(), quat=quat_o.tolist(),
                        contype=_OBSTACLE_CONTYPE,
                        conaffinity=_ROBOT_CONTYPE)
                else:
                    raise NotImplementedError(type(field))
                n += 1


@dataclasses.dataclass
class MujocoExecutionResult:
    contact: np.ndarray            # (B,) whether physics reported contact
    contact_step: np.ndarray       # (B,) first waypoint index with contact
    tracking_err: np.ndarray       # (B,) max |qpos - target| over the run
    qpos_executed: np.ndarray      # (B, H, d) executed joint positions


class MujocoExecutionEnv:
    """Execute planned trajectories on PD-servo robots in MuJoCo, each
    tracked waypoint by waypoint; a robot that makes contact is frozen (its
    servo target stops advancing) and its contact step recorded, as the
    reference's motion-planning controller does."""

    def __init__(self, robot, env=None, timestep: float = 0.002,
                 sphere_model: Optional[dict] = None, kp: float = 300.0,
                 kd: float = 20.0):
        import mujoco

        if sphere_model is None and getattr(robot, "name", "") == "RobotPanda":
            sphere_model = panda_sphere_model()
        obstacles = env.get_df_obj_list() if env is not None else ()
        self.spec, self.joint_names, self.dof_order = build_mj_spec(
            robot.model, sphere_model=sphere_model, obstacles=obstacles,
            timestep=timestep, kp=kp, kd=kd)
        self.mj_model = self.spec.compile()
        self.mj_data = mujoco.MjData(self.mj_model)
        self.robot = robot
        self.timestep = timestep

    def run_trajectories(self, trajs_pos, dt_plan: float = 0.04,
                         settle_steps: int = 50):
        """trajs_pos: (B, H, d) or (H, d) planned joint positions (a tensor
        on any device or an array) -> MujocoExecutionResult; ``contact[b]``
        is True where MuJoCo reports a robot-obstacle contact while
        executing trajectory b."""
        import mujoco

        trajs_pos = to_numpy(trajs_pos, np.float64)
        if trajs_pos.ndim == 2:
            trajs_pos = trajs_pos[None]
        # model dof columns into MuJoCo's qpos order
        trajs_pos = trajs_pos[..., np.asarray(self.dof_order, np.int64)]
        B, H, d = trajs_pos.shape
        inv_order = np.argsort(np.asarray(self.dof_order, np.int64))
        n_sub = max(1, int(round(dt_plan / self.timestep)))

        contact = np.zeros(B, bool)
        contact_step = np.full(B, -1, np.int64)
        tracking_err = np.zeros(B)
        qpos_exec = np.zeros((B, H, d))

        m, data = self.mj_model, self.mj_data
        for b in range(B):
            mujoco.mj_resetData(m, data)
            data.qpos[:d] = trajs_pos[b, 0]
            data.ctrl[:d] = trajs_pos[b, 0]
            mujoco.mj_forward(m, data)
            for _ in range(settle_steps):
                mujoco.mj_step(m, data)
            frozen = False
            target = trajs_pos[b, 0]
            for h in range(H):
                if not frozen:
                    target = trajs_pos[b, h]
                data.ctrl[:d] = target
                for _ in range(n_sub):
                    mujoco.mj_step(m, data)
                qpos_exec[b, h] = data.qpos[:d]
                if data.ncon > 0 and not frozen:
                    contact[b] = True
                    contact_step[b] = h
                    frozen = True       # contacted robots are frozen
                err = np.max(np.abs(data.qpos[:d] - target))
                tracking_err[b] = max(tracking_err[b], err)
        return MujocoExecutionResult(
            contact=contact, contact_step=contact_step,
            tracking_err=tracking_err,
            qpos_executed=qpos_exec[..., inv_order])
