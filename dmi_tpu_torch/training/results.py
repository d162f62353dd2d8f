# Copy of dmi_tpu/training/results.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Results-JSON artifact contract + seed averaging.

Bit-compatible with the reference's output files (BASELINE.md contract):
  * per-run:   {output_root}/{train_type}:{name}-results.json with
               dict(metrics=..., gts=..., preds=..., ids=...)
               (dmi/train.py:99-101)
  * per-dataset aggregate under a FileLock:
               {output_root}/{dataset}-results.json keyed
               '{train_type}:{name}-dsz{size}' -> per-encoder avg metrics
               (dmi/train.py:257-283)
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List

from filelock import FileLock


def run_results_path(output_root: str, train_type: str, name: str) -> str:
    return osp.join(output_root, f"{train_type}:{name}-results.json")


def save_run_results(
    output_root: str,
    train_type: str,
    name: str,
    metrics: Dict,
    gts: Dict,
    preds: Dict,
    ids: Dict,
    eval_env: Dict = None,
) -> str:
    """eval_env (dmi_tpu.evals.environment) annotates which scorer
    implementations/stages actually ran — stored top-level, OUTSIDE the
    metrics dict, so seed averaging still sees only numbers."""
    os.makedirs(output_root, exist_ok=True)
    if eval_env is None:
        from dmi_tpu_torch.evals.environment import eval_environment

        eval_env = eval_environment()
    results = dict(metrics=metrics, gts=gts, preds=preds, ids=ids, eval_env=eval_env)
    path = run_results_path(output_root, train_type, name)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path


def run_exists(output_root: str, train_type: str, name: str) -> bool:
    """Idempotent-skip condition (dmi/train_projector.py:337-339)."""
    return osp.exists(run_results_path(output_root, train_type, name))


def average_seed_results(
    seeds: List[int],
    name: str,
    dataset_size: str,
    dataset_name: str,
    train_type: str,
    output_root: str = "../outputs",
) -> Dict:
    """Average per-seed metric dicts and merge into the per-dataset JSON
    under a FileLock (dmi/train.py:257-283)."""
    results = []
    for seed in seeds:
        cur_name = f"{train_type}:{name}-dsz{dataset_size}-seed{seed}"
        with open(osp.join(output_root, f"{cur_name}-results.json"), "r") as f:
            results.append(json.load(f))

    avg_metrics: Dict[str, Dict[str, float]] = {}
    for enc_name in results[0]["metrics"].keys():
        avg_metrics[enc_name] = {}
        for metric in results[0]["metrics"][enc_name].keys():
            avg_metrics[enc_name][metric] = sum(
                r["metrics"][enc_name][metric] for r in results
            ) / len(results)

    results_file = osp.join(output_root, f"{dataset_name}-results.json")
    lock = FileLock(results_file + ".lock")
    with lock:
        results_dict = {}
        if osp.exists(results_file):
            with open(results_file, "r") as f:
                results_dict = json.load(f)
        results_dict[f"{train_type}:{name}-dsz{dataset_size}"] = avg_metrics
        with open(results_file, "w") as f:
            json.dump(results_dict, f, indent=2)
    return avg_metrics
