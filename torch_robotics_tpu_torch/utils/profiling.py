"""Profiling and tracing helpers (counterpart of
torch_robotics_tpu/utils/profiling.py): a ``torch.profiler`` capture
written to a directory, named spans in it, and a wall-clock aggregator for
named sections that waits for the device before it reads the clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["trace_to", "annotate", "SectionTimer"]


@contextlib.contextmanager
def trace_to(logdir):
    """Profile the block (CPU, and CUDA where it is available) and write a
    Chrome trace into ``logdir`` when it ends.  Yields the
    ``torch.profiler.profile``, whose events the caller may read after the
    block."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof


def annotate(name: str):
    """A named span in the profiler's trace, as a context manager."""
    return torch.profiler.record_function(name)


def _synchronize(tensors) -> None:
    """Wait for the devices that hold ``tensors``; with none, for the
    current CUDA device where CUDA is in use."""
    devices = {t.device for t in tensors if torch.is_tensor(t)}
    if not tensors and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class SectionTimer:
    """Accumulates the wall-clock time of named sections, each ended after
    the device has finished its work."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, *block_on):
        """Time the block; at its end wait for the devices of the tensors
        in ``block_on`` (for the current CUDA device with none)."""
        t0 = time.perf_counter()
        yield
        _synchronize(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_ms": 1000.0 * v / max(self.counts[k], 1)}
                for k, v in sorted(self.totals.items())}
