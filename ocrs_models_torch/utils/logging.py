"""Experiment logging (the port's copy of ``ocrs_models_tpu/utils/logging.py``).

Every record goes to a local JSONL run log, ``<project>-metrics.jsonl``;
Weights & Biases attaches on top when ``WANDB_API_KEY`` is set and the
``wandb`` package imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, project: str, run_dir: str = ".", config: Optional[dict] = None):
        self.project = project
        self.path = os.path.join(run_dir, f"{project}-metrics.jsonl")
        self._wandb = None
        if os.environ.get("WANDB_API_KEY"):
            try:
                import wandb

                wandb.init(project=project, config=config or {})
                self._wandb = wandb
            except ImportError:
                pass
        if config:
            self._write({"event": "config", **config})

    def _write(self, record: dict) -> None:
        record = {"time": time.time(), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["epoch"] = step
        self._write(rec)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
