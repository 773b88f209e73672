"""Progress logging from solver loops (counterpart of
torch_robotics_tpu/utils/logging.py).

The port's solvers are Python loops, so a logger is a plain call: no host
callback is needed to get a value out of a loop body.  ``log_every`` gives
such a call; ``MetricsAccumulator`` collects what it emits.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger("torch_robotics_tpu_torch")

__all__ = ["log_every", "MetricsAccumulator", "logger"]


def log_every(name: str, every: int = 10,
              printer: Optional[Callable] = None):
    """f(i, value) that emits (i, value) on every ``every``-th call,
    starting with the first, through ``printer(i, value)`` (by default
    ``logger.info``).  ``i`` and ``value`` may be tensors; a tensor value
    is read from the device only on the calls that emit.

    Example::

        log_cost = log_every("gpmp2/cost", every=25)
        for i in range(iters):
            ...
            log_cost(i, cost.mean())
    """
    emit = printer or (lambda i, v: logger.info("%s[%d] = %s", name, int(i),
                                                v))
    calls = [0]

    def log_fn(i, value):
        if calls[0] % every == 0:
            emit(i, value)
        calls[0] += 1

    return log_fn


class MetricsAccumulator:
    """Collects (name, step, value) triples."""

    def __init__(self):
        self.records = []

    def printer(self, name: str):
        def emit(i, v):
            self.records.append((name, int(i), float(v)))
        return emit

    def as_dict(self):
        out = {}
        for name, i, v in self.records:
            out.setdefault(name, []).append((i, v))
        return out
