"""Seeding (counterpart of torch_robotics_tpu/core/random.py).

The reference seeds three global generators; the JAX package seeds the
host's and returns a root PRNG key.  The port seeds Python's, numpy's and
torch's global generators and returns a ``torch.Generator`` on ``device``
seeded the same, which the port's samplers take explicitly.
"""
from __future__ import annotations

import random as _py_random

import numpy as np
import torch

from .device import resolve_device

__all__ = ["fix_random_seed"]


def fix_random_seed(seed: int, device="cuda") -> torch.Generator:
    """Seed Python's, numpy's and torch's generators with ``seed`` and
    return a generator on ``device`` seeded with it."""
    dev = resolve_device(device)
    _py_random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=dev).manual_seed(seed)
