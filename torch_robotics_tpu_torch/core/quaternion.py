"""Quaternion algebra, wxyz (Hamilton) convention, batched over leading
dims (counterpart of torch_robotics_tpu/core/quaternion.py).

Every function is branchless in the data: singular points (a zero tangent
vector, the identity, a zero angle) are guarded with ``torch.where`` on a
safe operand, so values and autograd gradients stay finite there, with the
reference's conventions (q and -q log to the same vector; the Taylor
expansion of sin(theta / 2) / theta near 0).  xyzw converters are given for
interop with engines that use xyzw.
"""
from __future__ import annotations

import torch

__all__ = [
    "q_exp_map", "q_log_map", "q_mul", "q_inverse", "q_div", "q_norm_squared",
    "q_to_rotation_matrix", "q_to_quaternion_matrix", "rotation_matrix_to_q",
    "q_to_axis_angles", "axis_angles_to_q", "q_to_euler", "euler_to_q",
    "q_convert_xyzw", "q_convert_wxyz", "q_parallel_transport",
]


def q_exp_map(v: torch.Tensor, base=None) -> torch.Tensor:
    """Exponential map R^3 -> S^3 at ``base`` (the identity if None):
    v (..., 3) -> (..., 4) wxyz; a zero v maps to the identity."""
    norm_v = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    pos = norm_v > 0.0
    safe = torch.where(pos, norm_v, torch.ones_like(norm_v))
    sinc = torch.where(pos, torch.sin(safe) / safe, torch.zeros_like(safe))
    w = torch.where(pos, torch.cos(safe), torch.ones_like(safe))
    q = torch.cat([w, sinc * v], dim=-1)
    return q if base is None else q_mul(base, q)


def q_log_map(q: torch.Tensor, base=None) -> torch.Tensor:
    """Log map S^3 -> R^3 at ``base`` (the identity if None): q (..., 4) ->
    (..., 3).  Where w < 0 the angle is shifted by -pi, so q and -q map to
    the same tangent vector; a zero vector part maps to 0."""
    if base is not None:
        return q_log_map(q_mul(q_inverse(base), q))
    vec, w = q[..., 1:], q[..., 0]
    norm_vec = torch.linalg.vector_norm(vec, dim=-1)
    valid = (norm_vec > 0.0) & (torch.abs(w) <= 1.0)
    acos = torch.arccos(torch.clamp(w, -1.0, 1.0))
    acos = torch.where(w < 0.0, acos - torch.pi, acos)
    safe = torch.where(valid, norm_vec, torch.ones_like(norm_vec))
    scale = torch.where(valid, acos / safe, torch.zeros_like(safe))
    return vec * scale[..., None]


def q_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product (..., 4) x (..., 4) -> (..., 4), batch dims
    broadcast."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def q_norm_squared(q: torch.Tensor) -> torch.Tensor:
    """|q|^2 (..., 1)."""
    return torch.sum(q * q, dim=-1, keepdim=True)


def q_inverse(q: torch.Tensor) -> torch.Tensor:
    """conj(q) / |q|^2."""
    scaling = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                           device=q.device)
    return q * scaling / q_norm_squared(q)


def q_div(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """q1 q2^-1."""
    return q_mul(q1, q_inverse(q2))


def q_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion (..., 4) -> (..., 3, 3) rotation matrix; the scale
    2/(q.q) handles non-unit quaternions."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack([
        1.0 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
        s * (x * y + z * w), 1.0 - s * (x * x + z * z), s * (y * z - x * w),
        s * (x * z - y * w), s * (y * z + x * w), 1.0 - s * (x * x + y * y),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def q_to_quaternion_matrix(q: torch.Tensor) -> torch.Tensor:
    """Left-multiplication matrix Q(q1) (..., 4, 4), with Q(q1) @ q2 =
    q_mul(q1, q2)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        w, -x, -y, -z,
        x, w, -z, y,
        y, z, w, -x,
        z, -y, x, w,
    ], dim=-1).reshape(w.shape + (4, 4))


def _sqrt_positive(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)


def rotation_matrix_to_q(rot_mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> wxyz quaternion, picking the
    best-conditioned of four candidate quaternions."""
    batch = rot_mat.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = \
        rot_mat.reshape(batch + (9,)).unbind(-1)
    q_abs = _sqrt_positive(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    quat_by_wxyz = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    cand = quat_by_wxyz / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(batch + (1, 4))
    return torch.gather(cand, -2, idx)[..., 0, :]


def q_to_euler(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion (..., 4) -> [roll, pitch, yaw] (..., 3), XYZ
    extrinsic, in q's dtype and the reference's operation order.  At gimbal
    lock the clipped arcsin and the sign of 1 - 2 (x^2 + y^2) decide the
    angles, so a float32 q gives the reference's float32 angles only in
    float32."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def _sin_half_angle_over_angle(angles: torch.Tensor,
                               eps: float = 1e-10) -> torch.Tensor:
    """sin(theta / 2) / theta, 0.5 - theta^2 / 48 where |theta| < eps."""
    small = torch.abs(angles) < eps
    safe = torch.where(small, torch.ones_like(angles), angles)
    return torch.where(small, 0.5 - angles * angles / 48.0,
                       torch.sin(safe / 2.0) / safe)


def q_to_axis_angles(q: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """wxyz (..., 4) -> axis * angle (..., 3)."""
    norm_q = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angles = 2.0 * torch.atan2(norm_q, q[..., :1])
    return q[..., 1:] / _sin_half_angle_over_angle(angles, eps)


def axis_angles_to_q(axis_angles: torch.Tensor,
                     eps: float = 1e-10) -> torch.Tensor:
    """axis * angle (..., 3) -> wxyz (..., 4)."""
    angles = torch.linalg.vector_norm(axis_angles, dim=-1, keepdim=True)
    s = _sin_half_angle_over_angle(angles, eps)
    return torch.cat([torch.cos(angles / 2.0), axis_angles * s], dim=-1)


def euler_to_q(euler: torch.Tensor) -> torch.Tensor:
    """[roll, pitch, yaw] (..., 3), XYZ extrinsic -> wxyz (..., 4)."""
    roll, pitch, yaw = euler.unbind(-1)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def q_convert_xyzw(q: torch.Tensor) -> torch.Tensor:
    """wxyz -> xyzw."""
    return torch.roll(q, -1, dims=-1)


def q_convert_wxyz(q: torch.Tensor) -> torch.Tensor:
    """xyzw -> wxyz."""
    return torch.roll(q, 1, dims=-1)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def q_parallel_transport(p_g: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                         eps: float = 1e-10) -> torch.Tensor:
    """Parallel transport of the tangent vector p_g (..., 3) from T_g S^3 to
    T_h S^3 (g, h (..., 4) wxyz); where the geodesic distance of g and h is
    below eps, p_g is returned unchanged."""
    dtype, dev = p_g.dtype, p_g.device
    Q_g = q_to_quaternion_matrix(g)
    Q_h = q_to_quaternion_matrix(h)
    B = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                   torch.eye(3, dtype=dtype, device=dev)], dim=0)
    log_g_h = q_log_map(h, base=g)
    m = torch.linalg.vector_norm(log_g_h, dim=-1)
    safe_m = torch.where(m < eps, torch.ones_like(m), m)
    u_vec = torch.cat([torch.zeros_like(log_g_h[..., :1]),
                       log_g_h / safe_m[..., None]], dim=-1)
    u = (Q_g @ u_vec[..., None])[..., 0]
    I4 = torch.eye(4, dtype=dtype, device=dev)
    R_g_h = (I4 - torch.sin(m)[..., None, None] * _outer(g, u)
             + (torch.cos(m) - 1.0)[..., None, None] * _outer(u, u))
    A = B.T @ Q_h.transpose(-1, -2) @ R_g_h @ Q_g @ B
    res = (A @ p_g[..., None])[..., 0]
    return torch.where((m < eps)[..., None], p_g, res)
