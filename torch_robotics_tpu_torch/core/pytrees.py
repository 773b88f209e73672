"""Numerical helpers shared across the port (counterpart of
torch_robotics_tpu/core/pytrees.py; the pytree machinery has no PyTorch
counterpart and is not ported)."""
from __future__ import annotations

import torch

__all__ = ["safe_norm"]


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """||x|| with a zero (not NaN) gradient at x = 0.

    Values equal ``torch.linalg.norm``; only the derivative at the origin
    changes (0 subgradient), which keeps gradients of SDFs finite for points
    exactly on sphere centers or inside rounded boxes.
    """
    s = torch.sum(x * x, dim=dim)
    nonzero = s > 0.0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, s, 1.0)),
                       0.0)
