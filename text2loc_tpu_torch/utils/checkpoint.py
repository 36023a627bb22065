"""Best-metric checkpoints of a trainer's whole state (the port of
text2loc_tpu/utils/checkpoint.py: CheckpointManager), written with
torch.save.

A checkpoint holds the model's state dict (parameters and BatchNorm
running statistics), the optimizer's (Adam's moments and step counts) and
the schedule's position, the step and the metric: a resumed run continues
the optimization where it stopped. The frozen text table is not training
state and is not saved. The files are the port's own; the JAX package's
Orbax checkpoints are not read.

Layout of a directory: `step_<n>.pt` per kept step and `metrics.json`
({step: metric}), both replaced atomically.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

_INDEX = "metrics.json"


def _file(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step)}.pt")


class CheckpointManager:
    """Best-metric-gated checkpoints: a save happens only when its metric
    beats the best so far (`mode` "max" or "min"), and the `keep_latest + 1`
    best checkpoints are kept (with gated saves, the latest ones)."""

    def __init__(self, directory: str, keep_latest: int = 1, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode {mode!r}: expected 'max' or 'min'")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.mode = mode
        self.keep = keep_latest + 1
        # The best metric on disk: a resumed run keeps the
        # save-only-on-improvement gate, so its first post-resume eval must
        # beat the best before the interruption.
        self.best_metric: Optional[float] = None
        best = self._best_step()
        if best is not None:
            self.best_metric = self._metrics()[best]

    def _metrics(self) -> Dict[int, float]:
        path = os.path.join(self.directory, _INDEX)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): float(v) for k, v in json.load(f).items()}

    def _write_metrics(self, metrics: Dict[int, float]) -> None:
        path = os.path.join(self.directory, _INDEX)
        with open(path + ".tmp", "w") as f:
            json.dump({str(k): v for k, v in sorted(metrics.items())}, f)
        os.replace(path + ".tmp", path)

    def _rank(self, metric: float) -> float:
        return metric if self.mode == "max" else -metric

    def _best_step(self) -> Optional[int]:
        metrics = self._metrics()
        if not metrics:
            return None
        return max(metrics, key=lambda s: (self._rank(metrics[s]), s))

    def _is_better(self, metric: float) -> bool:
        if self.best_metric is None:
            return True
        return metric > self.best_metric if self.mode == "max" else metric < self.best_metric

    def save(self, step: int, state, metric: float) -> bool:
        """Save `state` (an object with state_dict(), e.g.
        training.steps.TrainState, or a dict) at `step` if `metric` beats the
        best so far. Returns True when saved."""
        if not self._is_better(metric):
            return False
        self.best_metric = float(metric)
        payload = {"step": int(step), "metric": float(metric),
                   "state": state.state_dict() if hasattr(state, "state_dict") else state}
        path = _file(self.directory, step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        metrics = self._metrics()
        metrics[int(step)] = float(metric)
        ranked = sorted(metrics, key=lambda s: (self._rank(metrics[s]), s), reverse=True)
        for old in ranked[self.keep:]:
            del metrics[old]
        self._write_metrics(metrics)
        for old in ranked[self.keep:]:
            if os.path.exists(_file(self.directory, old)):
                os.remove(_file(self.directory, old))
        return True

    def restore(self, state_like=None, step: Optional[int] = None):
        """Load the given (or the best, else the latest) step. With
        `state_like` (an object with load_state_dict()), load into it and
        return it; without, return the saved state dict."""
        if step is None:
            step = self._best_step()
            if step is None:
                step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = torch.load(_file(self.directory, step), map_location="cpu",
                             weights_only=True)
        if state_like is None:
            return payload["state"]
        state_like.load_state_dict(payload["state"])
        return state_like

    def latest_step(self) -> Optional[int]:
        metrics = self._metrics()
        return max(metrics) if metrics else None

    def close(self) -> None:
        """Saves are synchronous: nothing is pending."""


def load_model_state(model: torch.nn.Module, directory: str) -> torch.nn.Module:
    """Load the model weights of the best checkpoint in a trainer's
    checkpoint directory (e.g. <workdir>/coarse_ckpt) into `model`. The
    directory does not record its mode ("max" for coarse, "min" for fine);
    saves are gated on improvement, so in either mode the latest step is the
    best."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"{directory}: no checkpoint directory")
    mgr = CheckpointManager(directory)
    model.load_state_dict(mgr.restore(step=mgr.latest_step())["model"])
    return model
