# Copy of dmi_tpu/data/collator.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Chat-batch collator with assistant-token label masking.

Reference semantics (dmi/data/base.py:14-62 `datacollator`):
  * labels start as a copy of input_ids
  * EOS appended to input_ids and labels; attention mask all ones
  * assistant_masks extended with 1 for the EOS; non-assistant tokens get
    label -100
  * pad to the batch max length on tokenizer.padding_side; **labels are
    padded with pad_token_id, not -100** — those positions (mask 0) DO
    count in the HF token-mean loss.  This is a quirk the published runs
    trained with, so it is preserved by default (mask_pad_labels=False).

TPU extension: `bucket` rounds the padded length up to a multiple so jitted
train steps see a bounded set of shapes.  Bucket-extension positions get
label -100 and attention 0, which provably leaves the loss value unchanged
(only -100 is excluded from HF's mean).  Batch-dim padding for ragged final
eval batches works the same way (labels all -100 rows).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def collate_chat_batch(
    tokenized: Dict[str, List[List[int]]],
    eos_token_id: int,
    pad_token_id: int,
    is_instruct: bool = True,
    padding_side: str = "right",
    bucket: int = 1,
    mask_pad_labels: bool = False,
) -> Dict[str, np.ndarray]:
    input_ids = [list(x) + [eos_token_id] for x in tokenized["input_ids"]]
    labels = [list(x) for x in input_ids]
    if is_instruct:
        amasks = [list(m) + [1] for m in tokenized["assistant_masks"]]
        for lab, am in zip(labels, amasks):
            for j, a in enumerate(am):
                if a == 0:
                    lab[j] = -100

    max_len = max(len(x) for x in input_ids)
    padded_len = -(-max_len // bucket) * bucket

    B = len(input_ids)
    out_ids = np.full((B, padded_len), pad_token_id, np.int32)
    out_mask = np.zeros((B, padded_len), np.int32)
    out_labels = np.full((B, padded_len), -100, np.int64)

    pad_label = -100 if mask_pad_labels else pad_token_id
    for i, (ids, lab) in enumerate(zip(input_ids, labels)):
        n = len(ids)
        if padding_side == "right":
            out_ids[i, :n] = ids
            out_mask[i, :n] = 1
            out_labels[i, :n] = lab
            # reference pads labels with pad_token_id up to the batch max;
            # bucket extension beyond max_len stays -100
            out_labels[i, n:max_len] = pad_label
        elif padding_side == "left":
            # left-pad within the bucketed width (reference pads within the
            # batch max; the extra bucket region leads)
            start = padded_len - n
            out_ids[i, start:] = ids
            out_mask[i, start:] = 1
            out_labels[i, start:] = lab
            out_labels[i, padded_len - max_len : start] = pad_label
        else:
            raise ValueError(padding_side)

    return {
        "input_ids": out_ids,
        "attention_mask": out_mask,
        "labels": out_labels,
    }


def pad_batch_dim(batch: Dict[str, np.ndarray], target_batch: int) -> Dict[str, np.ndarray]:
    """Extend the batch dimension with inert rows (attention 0, labels -100)
    so ragged final eval batches keep a static shape under jit."""
    B = batch["input_ids"].shape[0]
    if B == target_batch:
        return batch
    if B > target_batch:
        raise ValueError(f"batch {B} > target {target_batch}")
    out = {}
    for k, v in batch.items():
        pad_rows = np.zeros((target_batch - B, *v.shape[1:]), v.dtype)
        if k == "labels":
            pad_rows[:] = -100
        if k == "input_ids":
            pad_rows[:] = 0
        out[k] = np.concatenate([v, pad_rows], axis=0)
    return out
