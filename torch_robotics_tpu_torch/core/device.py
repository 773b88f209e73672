"""Explicit device selection.

The port never picks a device on its own: ``"cuda"`` is the default of every
constructor and entry point, and asking for it on a machine without a GPU
is an error, not a quiet move to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises RuntimeError
    when a CUDA device is requested and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path" % (str(device),))
    return dev


def disable_tf32() -> None:
    """Pin float32 products to full precision.

    The Gauss-Newton systems carry weights up to ~1e8 (1/sigma_coll^2); their
    normal equations NaN under reduced-precision products, which is why the
    JAX reference pins float32 matmuls (torch_robotics_tpu/solve/gpmp2.py
    gpmp2_step).  TF32 keeps ~3 decimal digits, so both switches go off.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
