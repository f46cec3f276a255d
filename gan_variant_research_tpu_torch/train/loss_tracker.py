"""Loss tracking with the reference's exact file contracts.

The port's own copy of ``gan_variant_research_tpu/train/loss_tracker.py``
(the port imports nothing of the JAX package). Three sinks:
- per-step append-only CSV ``losses_history.csv`` with columns
  step,d_loss,g_loss, flushed each write (utils/loss_tracker.py:32-42);
- per-N-step averaged JSON lines appended to ``train_log.txt``
  ("Step {step}: {json}", train_cutpp.py:449-459);
- images/sec and step-time fields in the JSON line (the JAX package's
  addition).
"""

from __future__ import annotations

import csv
import json
from collections import defaultdict
from pathlib import Path


class LossTracker:
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.log_dir / "losses_history.csv"
        self.txt_path = self.log_dir / "train_log.txt"
        self._file = None
        self._writer = None

    def start(self):
        self._file = open(self.csv_path, "a", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=["step", "d_loss", "g_loss"])
        if self.csv_path.stat().st_size == 0:
            self._writer.writeheader()
        return self

    def log(self, step: int, d_loss: float, g_loss: float):
        if self._writer is None:
            self.start()
        self._writer.writerow(
            {"step": step, "d_loss": float(d_loss), "g_loss": float(g_loss)}
        )
        self._file.flush()

    def log_json_line(self, step: int, avg_losses: dict):
        with open(self.txt_path, "a") as f:
            f.write(f"Step {step}: {json.dumps(avg_losses)}\n")

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None

    def load_history(self) -> dict:
        if not self.csv_path.exists():
            return {"steps": [], "d_losses": [], "g_losses": []}
        steps, d_losses, g_losses = [], [], []
        with open(self.csv_path) as f:
            for row in csv.DictReader(f):
                steps.append(int(row["step"]))
                d_losses.append(float(row["d_loss"]))
                g_losses.append(float(row["g_loss"]))
        return {"steps": steps, "d_losses": d_losses, "g_losses": g_losses}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


class Averager:
    """Accumulate per-step loss dicts, emit window averages
    (the defaultdict(list) accumulator, train_cutpp.py:415,446-459)."""

    def __init__(self):
        self._acc = defaultdict(list)

    def add(self, losses: dict):
        for k, v in losses.items():
            self._acc[k].append(float(v))

    def averages(self) -> dict:
        return {k: sum(v) / len(v) for k, v in self._acc.items() if v}

    def clear(self):
        self._acc.clear()
