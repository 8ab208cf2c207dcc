"""Metrics logging: values averaged between dumps, written as CSV and JSON
lines.

The part of ``latent_diffusion_planning_tpu/utils/logger.py`` the
``Workspace`` and the drivers call (``log_metrics``, ``dump``, ``note``):
a dump is a row of ``train.csv`` / ``eval.csv`` (rows at or after its step
from an earlier run dropped, the header widened when new keys appear, as
the JAX logger does) and a JSON object in ``train.jsonl`` / ``eval.jsonl``;
no TensorBoard or wandb.
"""

from __future__ import annotations

import csv
import datetime
import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Mapping


class Logger:
    """``log_metrics(metrics, step, prefix)`` accumulates; ``dump(step,
    prefix)`` writes the averages and prints a line."""

    def __init__(self, log_dir: str | Path, write: bool = True):
        """``write`` False (a rank other than 0 of a data-parallel run)
        keeps the averages and writes and prints nothing."""
        self.log_dir = Path(log_dir)
        self.write = write
        if write:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self._meters: dict[str, dict] = {
            "train": defaultdict(lambda: [0.0, 0]),
            "eval": defaultdict(lambda: [0.0, 0])}

    def log_metrics(self, metrics: Mapping[str, Any], step: int,
                    prefix: str = "train") -> None:
        """Numbers and 0-d tensors are kept (a tensor on the card is read
        here, so this waits for it); anything else is skipped."""
        group = self._meters["train" if prefix == "train" else "eval"]
        for k, v in metrics.items():
            try:
                value = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
            group[k][0] += value
            group[k][1] += 1

    def dump(self, step: int, prefix: str) -> dict:
        """Write and print the averages logged under ``prefix`` since the
        last dump; returns them."""
        group = self._meters[prefix]
        data = {k: total / n for k, (total, n) in group.items()}
        group.clear()
        if data and self.write:
            with open(self.log_dir / f"{prefix}.jsonl", "a") as f:
                f.write(json.dumps({"step": step, **data}) + "\n")
            self._write_csv(self.log_dir / f"{prefix}.csv",
                            {"step": step, **data})
            shown = " | ".join(f"{k}: {v:.4g}"
                               for k, v in sorted(data.items())[:12])
            print(f"step: {step} | {prefix}: {shown}", flush=True)
        return data

    @staticmethod
    def _write_csv(path: Path, row: dict) -> None:
        rows = []
        if path.exists():
            with open(path, newline="") as f:
                rows = [r for r in csv.DictReader(f)
                        if r.get("step") and float(r["step"]) < row["step"]]
        fields = sorted(set(row) | {k for r in rows for k in r})
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields, restval=0.0)
            writer.writeheader()
            writer.writerows(rows + [row])

    def note(self, text: str) -> None:
        if not self.write:
            return
        stamp = datetime.datetime.now().strftime("%H:%M:%S")
        print(f"[{stamp}] {text}", flush=True)
