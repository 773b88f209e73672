"""Frame and MotionVec: batched containers over the SE(3) functions
(counterpart of torch_robotics_tpu/core/frame.py).

The port's kernels and solvers pass raw (R, t) tensors; these immutable
classes are for interactive use and for code written against the
reference's frame API.
"""
from __future__ import annotations

import dataclasses

import torch

from .device import resolve_device
from .quaternion import (q_convert_xyzw, q_to_rotation_matrix,
                         rotation_matrix_to_q)
from .se3 import (invert_transform, multiply_transform, pack_homogeneous,
                  vector3_to_skew_symm_matrix)

__all__ = ["Frame", "MotionVec"]


def _matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class Frame:
    """Batched rigid transform (R: (..., 3, 3), t: (..., 3))."""
    rot: torch.Tensor
    trans: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device="cuda") -> "Frame":
        dev = resolve_device(device)
        return cls(torch.eye(3, dtype=dtype, device=dev).expand(
                       tuple(batch_shape) + (3, 3)),
                   torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                               device=dev))

    @classmethod
    def from_pose(cls, pose: torch.Tensor) -> "Frame":
        """pose (..., 7) = [x, y, z, qw, qx, qy, qz]."""
        return cls(q_to_rotation_matrix(pose[..., 3:]), pose[..., :3])

    @property
    def rotation(self) -> torch.Tensor:
        return self.rot

    @property
    def translation(self) -> torch.Tensor:
        return self.trans

    def multiply_transform(self, other: "Frame") -> "Frame":
        return Frame(*multiply_transform(self.rot, self.trans, other.rot,
                                         other.trans))

    def inverse(self) -> "Frame":
        return Frame(*invert_transform(self.rot, self.trans))

    def get_transform_matrix(self) -> torch.Tensor:
        return pack_homogeneous(self.rot, self.trans)

    def get_quaternion(self, wxyz: bool = False) -> torch.Tensor:
        """The rotation's quaternion, xyzw as the reference's frame gives it
        by default, wxyz with the flag."""
        q = rotation_matrix_to_q(self.rot)
        return q if wxyz else q_convert_xyzw(q)

    def transform_point(self, point: torch.Tensor) -> torch.Tensor:
        """point (..., n, 3) -> rotated and translated."""
        return point @ self.rot.transpose(-1, -2) + self.trans[..., None, :]

    def trans_cross_rot(self) -> torch.Tensor:
        return vector3_to_skew_symm_matrix(self.trans) @ self.rot

    def get_euler(self):
        """(roll, pitch, yaw) of the rotation."""
        R = self.rot
        return (torch.atan2(R[..., 2, 1], R[..., 2, 2]),
                torch.asin(-R[..., 2, 0]),
                torch.atan2(R[..., 1, 0], R[..., 0, 0]))


@dataclasses.dataclass(frozen=True)
class MotionVec:
    """Spatial motion vector (linear, angular), batched (..., 3) each."""
    lin: torch.Tensor
    ang: torch.Tensor

    @classmethod
    def zero(cls, batch_shape=(), dtype=torch.float32,
             device="cuda") -> "MotionVec":
        z = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                        device=resolve_device(device))
        return cls(z, z)

    def add_motion_vec(self, mv: "MotionVec") -> "MotionVec":
        return MotionVec(self.lin + mv.lin, self.ang + mv.ang)

    def cross_motion_vec(self, mv: "MotionVec") -> "MotionVec":
        new_ang = torch.linalg.cross(self.ang, mv.ang)
        new_lin = (torch.linalg.cross(self.ang, mv.lin)
                   + torch.linalg.cross(self.lin, mv.ang))
        return MotionVec(new_lin, new_ang)

    def transform(self, frame: Frame) -> "MotionVec":
        new_ang = _matvec(frame.rot, self.ang)
        new_lin = (_matvec(frame.trans_cross_rot(), self.ang)
                   + _matvec(frame.rot, self.lin))
        return MotionVec(new_lin, new_ang)

    def get_vector(self) -> torch.Tensor:
        """[angular, linear] (..., 6)."""
        return torch.cat([self.ang, self.lin], dim=-1)

    def dot(self, mv: "MotionVec") -> torch.Tensor:
        return (torch.sum(self.ang * mv.ang, dim=-1)
                + torch.sum(self.lin * mv.lin, dim=-1))
