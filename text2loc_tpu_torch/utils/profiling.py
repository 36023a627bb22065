"""Stage timing for the trainers (the port's own copy of StageTimer from
text2loc_tpu/utils/profiling.py, and block_on for torch tensors)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    """Accumulating named wall-clock stages; call `report()` for a summary."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            for name in sorted(self.totals)
        ]
        return "\n".join(lines)


def block_on(tensors):
    """Wait until the work that produces `tensors` (a tensor, a nested
    list / tuple / dict of them, or None) is done: synchronizes each CUDA
    device they lie on; CPU tensors are ready already. Returns `tensors`."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tensors)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tensors
