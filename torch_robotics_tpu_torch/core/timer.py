"""Device-synchronized wall-clock timer (counterpart of
torch_robotics_tpu/core/timer.py's ``TimerTPU``, under the reference's
name ``TimerCUDA``).

CUDA work is asynchronous: on a CUDA device the timer records a CUDA event
on the current stream when it is entered and another when it exits, waits
for the second and reads the time between them, so it covers the work
enqueued inside the block.  Only a timer built for the CPU
(``TimerCUDA(device="cpu")``) reads the host clock.
"""
from __future__ import annotations

import time

import torch

from .device import resolve_device

__all__ = ["TimerCUDA"]


class TimerCUDA:
    """Context-manager timer; ``elapsed`` in seconds after the block::

        with TimerCUDA() as t:
            out = fn(x)
            t.block_on(out)
        print(t.elapsed)

    ``block_on(*tensors)`` keeps the JAX timer's contract (name the
    outputs the block waits for)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.elapsed = 0.0

    def __enter__(self):
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._start = torch.cuda.Event(enable_timing=True)
                self._end = torch.cuda.Event(enable_timing=True)
                self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def block_on(self, *tensors):
        """Nothing to wait for here: the exit waits for the end event,
        which follows every kernel of the block on its stream."""

    def __exit__(self, exc_type, exc_value, exc_tb):
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._end.record()
            self._end.synchronize()
            self.elapsed = self._start.elapsed_time(self._end) / 1e3
        else:
            self.elapsed = time.perf_counter() - self._start
        return False
