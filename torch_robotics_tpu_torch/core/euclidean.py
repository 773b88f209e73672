"""Euclidean manifold maps: the log, exp and transport of R^n (counterpart
of torch_robotics_tpu/core/euclidean.py)."""
from __future__ import annotations

import torch

__all__ = ["e_log_map", "e_exp_map", "e_parallel_transport"]


def e_log_map(p: torch.Tensor, base=None) -> torch.Tensor:
    return p if base is None else p - base


def e_exp_map(v: torch.Tensor, base=None) -> torch.Tensor:
    return v if base is None else v + base


def e_parallel_transport(v: torch.Tensor, g=None, h=None) -> torch.Tensor:
    return v
