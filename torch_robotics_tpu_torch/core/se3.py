"""SO(3) / SE(3) helpers: rotation constructors, composition, distances and
the SO(3) maps (counterpart of torch_robotics_tpu/core/se3.py).

Transforms are carried as (R (..., 3, 3), t (..., 3)) pairs inside the
port and as (..., 4, 4) homogeneous matrices at its boundaries; points are
row vectors (point @ R^T + t)."""
from __future__ import annotations

import math

import torch

from .device import resolve_device
from .quaternion import rotation_matrix_to_q

DEFAULT_ACOS_BOUND: float = 1.0 - 1e-4

__all__ = [
    "x_rot", "y_rot", "z_rot", "rpy_to_rotation_matrix", "axis_angle_rotation",
    "multiply_transform", "multiply_inv_transform", "invert_transform",
    "transform_point", "rotate_point", "pack_homogeneous", "unpack_homogeneous",
    "vector3_to_skew_symm_matrix", "skew_symm_matrix_to_vec",
    "SE3_distance", "so3_relative_angle", "so3_rotation_angle",
    "acos_linear_extrapolation", "log_SO3", "exp_map_so3", "minus_SO3",
    "link_pos_from_link_tensor", "link_rot_from_link_tensor",
    "link_quat_from_link_tensor",
]


def vector3_to_skew_symm_matrix(v: torch.Tensor) -> torch.Tensor:
    """v (..., 3) -> [v]_x (..., 3, 3), with [v]_x x = v cross x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _rot_from_cs(c, s, axis: int) -> torch.Tensor:
    """Rotation about coordinate axis ``axis`` from cos / sin values."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == 1:
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(c.shape + (3, 3))


def _axis_rot(angle, axis: int, device) -> torch.Tensor:
    if not torch.is_tensor(angle):
        angle = torch.tensor(angle, dtype=torch.float32,
                             device=resolve_device(device))
    return _rot_from_cs(torch.cos(angle), torch.sin(angle), axis)


def x_rot(angle, device="cuda") -> torch.Tensor:
    """Rotation about x by ``angle`` (...,) -> (..., 3, 3), on the angle's
    device (``device`` for a Python number)."""
    return _axis_rot(angle, 0, device)


def y_rot(angle, device="cuda") -> torch.Tensor:
    """Rotation about y by ``angle``, as ``x_rot``."""
    return _axis_rot(angle, 1, device)


def z_rot(angle, device="cuda") -> torch.Tensor:
    """Rotation about z by ``angle``, as ``x_rot``."""
    return _axis_rot(angle, 2, device)


def rpy_to_rotation_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF fixed-frame rotation R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1).reshape(rpy.shape[:-1] + (3, 3))


def axis_angle_rotation(axis: torch.Tensor, angle: torch.Tensor):
    """Rodrigues rotation about a unit axis: axis (..., 3), angle (...,) ->
    (..., 3, 3)."""
    K = vector3_to_skew_symm_matrix(axis)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def skew_symm_matrix_to_vec(R: torch.Tensor) -> torch.Tensor:
    """The vector of a skew matrix (..., 3, 3) -> (..., 3)."""
    return torch.stack([R[..., 2, 1], R[..., 0, 2], R[..., 1, 0]], dim=-1)


def multiply_transform(w_rot_l, w_trans_l, l_rot_c, l_trans_c):
    """Compose (R_wl, t_wl) with (R_lc, t_lc) -> (R_wc, t_wc)."""
    return (w_rot_l @ l_rot_c,
            (w_rot_l @ l_trans_c[..., None])[..., 0] + w_trans_l)


def invert_transform(rot, trans):
    """(R, t) -> (R^T, -R^T t)."""
    rot_t = rot.transpose(-1, -2)
    return rot_t, -(rot_t @ trans[..., None])[..., 0]


def multiply_inv_transform(l_rot_w, l_trans_w, l_rot_c, l_trans_c):
    """(R_lw, t_lw)^-1 composed with (R_lc, t_lc)."""
    inv_rot, inv_trans = invert_transform(l_rot_w, l_trans_w)
    return multiply_transform(inv_rot, inv_trans, l_rot_c, l_trans_c)


def transform_point(point: torch.Tensor, rot: torch.Tensor,
                    trans: torch.Tensor) -> torch.Tensor:
    """point @ R^T + t for points (..., 3) or (..., n, 3)."""
    return rotate_point(point, rot) + trans


def rotate_point(point: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """point @ R^T in row-vector form: (..., 3) x (..., 3, 3) -> (..., 3)."""
    return torch.matmul(point[..., None, :], rot.transpose(-1, -2))[..., 0, :]


def pack_homogeneous(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(R (..., 3, 3), t (..., 3)) -> (..., 4, 4), the batch dims
    broadcast."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    top = torch.cat([rot.expand(batch + (3, 3)),
                     trans.expand(batch + (3,))[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype,
                          device=rot.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def unpack_homogeneous(H: torch.Tensor):
    """(..., 4, 4) -> (R (..., 3, 3), t (..., 3))."""
    return H[..., :3, :3], H[..., :3, 3]


def acos_linear_extrapolation(x: torch.Tensor,
                              bounds=(-DEFAULT_ACOS_BOUND,
                                      DEFAULT_ACOS_BOUND)) -> torch.Tensor:
    """arccos inside ``bounds``, its first-order Taylor expansion at the
    bound outside them (finite gradients near +-1)."""
    lower, upper = bounds
    if lower > upper:
        raise ValueError("lower bound has to be smaller or equal to upper "
                         "bound.")
    if lower <= -1.0 or upper >= 1.0:
        raise ValueError("Both lower bound and upper bound have to be "
                         "within (-1, 1).")

    def linear(x0):
        return (x - x0) * (-1.0 / math.sqrt(1.0 - x0 * x0)) + math.acos(x0)

    res = torch.arccos(torch.clamp(x, lower, upper))
    res = torch.where(x >= upper, linear(upper), res)
    return torch.where(x <= lower, linear(lower), res)


def so3_rotation_angle(R: torch.Tensor, cos_angle: bool = False,
                       eps: float = 1e-4) -> torch.Tensor:
    """Rotation angle of R (..., 3, 3) (its cosine with ``cos_angle``);
    ``eps`` > 0 extrapolates the arccos linearly within eps of +-1."""
    phi_cos = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if eps > 0.0:
        return acos_linear_extrapolation(phi_cos, (-(1.0 - eps), 1.0 - eps))
    return torch.arccos(phi_cos)


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor,
                       cos_angle: bool = False,
                       eps: float = 1e-4) -> torch.Tensor:
    """Angle of R1 R2^T."""
    return so3_rotation_angle(R1 @ R2.transpose(-1, -2),
                              cos_angle=cos_angle, eps=eps)


def SE3_distance(H_batch: torch.Tensor, H_target: torch.Tensor,
                 w_pos: float = 1.0, w_rot: float = 1.0):
    """w_rot (1 - cos angle(R1 R2^T)) + w_pos |t1 - t2| between homogeneous
    transforms (..., 4, 4), the batch dims broadcast."""
    D = 0.0
    if w_rot > 0.0:
        D = D + w_rot * (1.0 - so3_relative_angle(
            H_batch[..., :3, :3], H_target[..., :3, :3], cos_angle=True))
    if w_pos > 0.0:
        D = D + w_pos * torch.linalg.vector_norm(
            H_batch[..., :-1, -1] - H_target[..., :-1, -1], dim=-1)
    return D


def log_SO3(R: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """Matrix log of a rotation (..., 3, 3): theta * omega_hat, a skew
    matrix."""
    trR = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
                      / 2.0, -1.0, 1.0)
    theta = torch.arccos(trR)[..., None, None]
    return theta * ((R - R.transpose(-1, -2))
                    / (2.0 * torch.sin(theta) + eps))


def exp_map_so3(omega: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """Rodrigues' formula for omega (..., 3) -> (..., 3, 3), eps-guarded at
    omega = 0."""
    omegahat = vector3_to_skew_symm_matrix(omega)
    norm = torch.linalg.vector_norm(omega, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return (eye + (torch.sin(norm) / (norm + eps)) * omegahat
            + ((1.0 - torch.cos(norm)) / torch.square(norm + eps))
            * (omegahat @ omegahat))


def minus_SO3(R1: torch.Tensor, R2: torch.Tensor,
              eps: float = 1.0e-14) -> torch.Tensor:
    """The rotation vector of R1 R2^T (..., 3)."""
    return skew_symm_matrix_to_vec(log_SO3(R1 @ R2.transpose(-1, -2),
                                           eps=eps))


def link_pos_from_link_tensor(link_tensor: torch.Tensor) -> torch.Tensor:
    """Positions from (..., 3, 3) planar or (..., 4, 4) spatial poses."""
    if link_tensor.shape[-1] == 3:
        return link_tensor[..., :2, 2]
    if link_tensor.shape[-1] == 4:
        return link_tensor[..., :3, 3]
    raise ValueError("unexpected link tensor trailing dim %d"
                     % link_tensor.shape[-1])


def link_rot_from_link_tensor(link_tensor: torch.Tensor) -> torch.Tensor:
    """Rotations from (..., 3, 3) planar or (..., 4, 4) spatial poses."""
    if link_tensor.shape[-1] == 3:
        return link_tensor[..., :2, :2]
    if link_tensor.shape[-1] == 4:
        return link_tensor[..., :3, :3]
    raise ValueError("unexpected link tensor trailing dim %d"
                     % link_tensor.shape[-1])


def link_quat_from_link_tensor(link_tensor: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions of (..., 4, 4) spatial poses."""
    return rotation_matrix_to_q(link_rot_from_link_tensor(link_tensor))
