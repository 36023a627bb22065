"""Epoch-level metric logging and curve plots (the port's own copy of
text2loc_tpu/utils/logging.py: MetricLogger), with two additions: `steps`,
the per-step rows that the port's trainers append, and `quiet`, which keeps
the rows without printing them (a data-parallel rank other than 0)."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional


class MetricLogger:
    """Accumulates per-epoch scalars; prints, JSONL-logs and plots them."""

    def __init__(self, log_path: Optional[str] = None, quiet: bool = False):
        self.quiet = quiet
        self.history: Dict[str, list] = defaultdict(list)
        # Epoch index per appended value: metrics logged every eval_every
        # epochs plot against their real epoch, not their call index.
        self.epochs: Dict[str, list] = defaultdict(list)
        # One {"epoch", "step", "loss", "seconds"} row per train step
        # (`seconds`: host wall time of the step, ending when its loss is
        # read back), appended by the trainers; not written to the log.
        self.steps: List[dict] = []
        self.log_path = log_path
        if log_path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    def log(self, epoch: int, **metrics: float) -> None:
        parts = [f"epoch {epoch:03d}"]
        for name, value in metrics.items():
            self.history[name].append(float(value))
            self.epochs[name].append(int(epoch))
            parts.append(f"{name}={value:0.4f}")
        if not self.quiet:
            print("  ".join(parts), flush=True)
        if self.log_path is not None:
            with open(self.log_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, **{
                    k: float(v) for k, v in metrics.items()
                }}) + "\n")

    def plot(self, path: str) -> Optional[str]:
        """Metric-curve grid PNG; None where matplotlib is absent."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        names = sorted(self.history)
        if not names:
            return None
        rows = (len(names) + 2) // 3
        fig, axes = plt.subplots(rows, 3, figsize=(12, 3 * rows), squeeze=False)
        for i, name in enumerate(names):
            ax = axes[i // 3][i % 3]
            ax.plot(self.epochs[name], self.history[name])
            ax.set_title(name)
            ax.grid(True, alpha=0.3)
        for j in range(len(names), rows * 3):
            axes[j // 3][j % 3].axis("off")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
