"""Shared generate/eval helpers for the trainers (counterpart of
dmi_tpu/training/generation.py).  The data and eval modules (the port's
copies of dmi_tpu's framework-free ones) are imported where they are used:
a trainer that never generates loads none of them, nor the scorers'
dependencies."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def prefix_prompt_ids(tokenizer, loader, batch_size: int, device="cpu") -> torch.Tensor:
    """Chat-template generation prompt for the loader's instruction
    (dmi/train.py:198-204: fixed PREFIX, else prefixes[0]), tiled to
    [batch_size, P] int64 on `device`."""
    from dmi_tpu_torch.data.loader import TOKENIZER_LOCK

    prefix = loader.PREFIX if loader.PREFIX is not None else loader.prefixes[0]
    with TOKENIZER_LOCK:
        ids = tokenizer.apply_chat_template(
            [{"role": "user", "content": prefix}],
            tokenize=True,
            add_generation_prompt=True,
        )
    row = torch.as_tensor(np.asarray(ids, np.int64), device=device)
    return row[None, :].repeat(batch_size, 1)


def safe_batch_decode(tokenizer, token_array, **kw):
    """tokenizer.batch_decode under the shared tokenizer lock (the batch
    prefetcher tokenizes concurrently in its worker thread)."""
    from dmi_tpu_torch.data.loader import TOKENIZER_LOCK

    with TOKENIZER_LOCK:
        return tokenizer.batch_decode(token_array, **kw)


def pad_emb_rows(embs: np.ndarray, target: int) -> np.ndarray:
    """Pad the batch dim by REPEATING the last real row: zero rows would
    L2-normalize to NaN and their non-EOS argmax chains would defeat the
    decode early-exit."""
    real = embs.shape[0]
    if real == target:
        return embs
    pad = np.repeat(embs[-1:], target - real, axis=0)
    return np.concatenate([embs, pad], axis=0)


def metrics_for(loader, preds: List[str], ids: List[str], gts: List[str],
                run_name: str, mode: str, data_root: str) -> Dict[str, float]:
    """Metric dispatch: GT-file datasets get the full calc_metrics suite;
    pretrain datasets (no GT files; the reference crashes there) score
    against the decoded references."""
    if loader.dataset_name in ("chebi20", "sydney", "candels"):
        from dmi_tpu_torch.evals.metrics import calc_metrics

        return calc_metrics(preds, ids, loader.dataset_name, run_name, mode, data_root)
    from dmi_tpu_torch.evals.captions import caption_evaluate

    return caption_evaluate(preds, gts)


def comp_metric(all_metrics: Dict[str, Dict[str, float]]):
    """Best-checkpoint comparison metric: coco_cider when every manager
    reports it, else bleu, averaged over the managers
    (dmi/train_projector.py:85-88)."""
    shared = None
    for ms in all_metrics.values():
        keys = set(ms.keys())
        shared = keys if shared is None else (shared & keys)
    comp = "coco_cider" if "coco_cider" in (shared or ()) else "bleu"
    val = sum(m[comp] for m in all_metrics.values()) / len(all_metrics)
    return comp, val
