# Copy of dmi_tpu/utils/logging.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Metric logging: JSONL stream + optional wandb.

The reference logs train/eval losses, per-metric scalars and prediction
tables to wandb (dmi/train.py:70,118,142,169-185; dmi/utils/model_utils.py:
90-95).  wandb is optional here (zero-egress environments): every record
always lands in a local JSONL stream; wandb mirrors it when importable and
WANDB_MODE isn't disabled.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, run_name: str, project: str, out_dir: str = "logs", use_wandb: bool = True):
        self.run_name = run_name
        os.makedirs(out_dir, exist_ok=True)
        self.path = osp.join(out_dir, f"{run_name}.metrics.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb and os.environ.get("WANDB_MODE") != "disabled":
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=run_name, reinit=True)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {"t": time.time(), "step": step, **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def dump_config_snapshot(run_name: str, *arg_groups, out_dir: str = "logs") -> str:
    """Persist the fully-resolved arg groups for the run (the reference
    pushes these to wandb.config, dmi/utils/model_utils.py:90-95)."""
    from dmi_tpu_torch.config import asdict_flat

    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, f"{run_name}.config.json")
    with open(path, "w") as f:
        json.dump(asdict_flat(*arg_groups), f, indent=2, default=str)
    return path
