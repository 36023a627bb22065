"""Stage timing and traces (port of text2loc_tpu/utils/profiling.py):
StageTimer, the port's own copy; profile_trace over torch.profiler where
the JAX package wraps jax.profiler; block_on for torch tensors."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

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

    def rate(self, name: str, items: int) -> float:
        """items/sec for a stage (the reference's queries/sec print)."""
        return items / max(self.totals.get(name, 0.0), 1e-9)

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            for name in sorted(self.totals)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the work inside the context, written under
    `log_dir` as a `*.pt.trace.json` (tensorboard_trace_handler: TensorBoard's
    profiler plugin and Perfetto read it) when the context ends; yields the
    `profile` object (key_averages(), events()). It records the CPU, and
    the CUDA device whenever a card is present: a profiler without CUDA
    activity on such a machine raises rather than record the CPU alone.
    With `log_dir` None it does nothing and yields None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile, supported_activities,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("profile_trace: this torch build's profiler cannot record "
                               "CUDA activity, and a CUDA card is present")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


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
