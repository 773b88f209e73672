"""wxyz quaternion <-> rotation matrix (counterpart of the two functions of
torch_robotics_tpu/core/quaternion.py that the main path uses)."""
from __future__ import annotations

import torch

__all__ = ["q_to_rotation_matrix", "rotation_matrix_to_q"]


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
