"""Batched forward kinematics on a compiled KinematicModel (counterpart of
``fk_all_links`` in torch_robotics_tpu/kin/fk.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .model import KinematicModel

__all__ = ["fk_all_links"]


def fk_all_links(model: KinematicModel, q: torch.Tensor,
                 link_list: Optional[Sequence[str]] = None):
    """Link poses as homogeneous matrices: q (..., n_dofs) ->
    (..., n_links, 4, 4) in URDF file order; ``link_list`` selects and
    orders a subset of links."""
    from ..ops.lanes_fk import fk_lanes
    batch = q.shape[:-1]
    d = q.shape[-1]
    R_w, t_w = fk_lanes(model, q.reshape(-1, d).T)
    links = (range(model.n_links) if link_list is None
             else [model.link_index(n) for n in link_list])
    R = torch.stack([R_w[li] for li in links])              # (L, 3, 3, N)
    t = torch.stack([t_w[li] for li in links])              # (L, 3, N)
    L, N = R.shape[0], R.shape[-1]
    H = torch.zeros((N, L, 4, 4), dtype=q.dtype, device=q.device)
    H[..., :3, :3] = R.permute(3, 0, 1, 2)
    H[..., :3, 3] = t.permute(2, 0, 1)
    H[..., 3, 3] = 1.0
    return H.reshape(batch + (L, 4, 4))
