"""Kinematic execution harness: PD-tracked trajectory rollout and contact
check (counterpart of torch_robotics_tpu/sim/rollout.py).

N robots execute their planned joint trajectories in parallel: PD
position/velocity control on double-integrator joints, ``substeps``
explicit steps a waypoint, the task's collision check after each
waypoint, and a robot that touched an obstacle stays where it was, at zero
velocity, for the rest of the rollout.  The reference's ``lax.scan`` over
the horizon is a loop over H here, on the tensors' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["PDControllerParams", "ExecutionResult", "execute_trajectories"]


@dataclasses.dataclass(frozen=True)
class PDControllerParams:
    kp: float = 50.0
    kd: float = 10.0
    dt: float = 0.04
    substeps: int = 4
    max_acc: float = 100.0


class ExecutionResult(NamedTuple):
    q: torch.Tensor               # (..., H, d) executed positions
    qd: torch.Tensor              # (..., H, d) executed velocities
    contact: torch.Tensor         # (..., H) bool contact at each step
    frozen: torch.Tensor          # (...,) robot froze on contact
    tracking_error: torch.Tensor  # (...,) mean |q - q_ref|


def execute_trajectories(collision_fn: Callable, trajs_pos: torch.Tensor,
                         trajs_vel: torch.Tensor,
                         params: PDControllerParams = PDControllerParams()
                         ) -> ExecutionResult:
    """Track reference trajectories with a PD controller.

    collision_fn: q (..., d) -> bool (...), the contact check (e.g. a
    task's ``_compute_collision``); trajs_pos, trajs_vel: (..., H, d)
    reference waypoints.  Each waypoint's state is the one after its
    substeps, or the frozen state of a robot in contact before it."""
    q = trajs_pos[..., 0, :]
    qd = torch.zeros_like(q)
    frozen = torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
    sub_dt = params.dt / params.substeps
    qs, qds, contacts = [], [], []
    for t in range(trajs_pos.shape[-2]):
        q_ref, qd_ref = trajs_pos[..., t, :], trajs_vel[..., t, :]
        q_s, qd_s = q, qd
        for _ in range(params.substeps):
            acc = params.kp * (q_ref - q_s) + params.kd * (qd_ref - qd_s)
            acc = torch.clamp(acc, -params.max_acc, params.max_acc)
            qd_s = qd_s + acc * sub_dt
            q_s = q_s + qd_s * sub_dt
        contact = collision_fn(q_s)
        q = torch.where(frozen[..., None], q, q_s)
        qd = torch.where(frozen[..., None], torch.zeros_like(qd), qd_s)
        frozen = frozen | contact
        qs.append(q)
        qds.append(qd)
        contacts.append(contact)
    qs = torch.stack(qs, dim=-2)
    err = (qs - trajs_pos).abs().mean(dim=(-1, -2))
    return ExecutionResult(q=qs, qd=torch.stack(qds, dim=-2),
                           contact=torch.stack(contacts, dim=-1),
                           frozen=frozen, tracking_error=err)
