# Copy of dmi_tpu/evals/coco_eval.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""COCO-caption evaluation harness (COCO + COCOEvalCap equivalent).

Replaces the reference's Java-backed `cococap` COCO/COCOEvalCap pipeline
(dmi/utils/eval_utils.py:183-207): load a COCO-format annotation JSON, PTB
tokenize ground truths and predictions, and compute Bleu_1..4 / METEOR /
ROUGE_L / CIDEr natively.  SPICE (a Java dependency graph scorer) is not
part of any metric the reference reads and is omitted.

Duplicate prediction image_ids (the eval loaders emit one row per caption,
so an image with k reference captions appears k times) keep the FIRST
prediction per image — deterministic and order-stable.
"""

from __future__ import annotations

import json
from typing import Dict, List

from dmi_tpu_torch.evals.bleu import coco_bleu
from dmi_tpu_torch.evals.cider import cider_d
from dmi_tpu_torch.evals.meteor15 import meteor15_corpus
from dmi_tpu_torch.evals.rouge import rouge_l
from dmi_tpu_torch.evals.tokenize import ptb_tokenize


def load_coco_annotations(path: str) -> Dict[str, List[str]]:
    with open(path, "r") as f:
        data = json.load(f)
    gts: Dict[str, List[str]] = {}
    for ann in data["annotations"]:
        gts.setdefault(str(ann["image_id"]), []).append(ann["caption"])
    return gts


def coco_caption_eval(
    annotation_path: str, predictions: List[dict]
) -> Dict[str, float]:
    """predictions: [{'image_id': ..., 'caption': ...}] (reference
    temp-JSON schema, dmi/utils/eval_utils.py:185-193)."""
    gts = load_coco_annotations(annotation_path)

    preds: Dict[str, str] = {}
    for p in predictions:
        preds.setdefault(str(p["image_id"]), p["caption"])

    img_ids = [i for i in preds if i in gts]
    if not img_ids:
        raise ValueError("no prediction image_ids found in annotations")

    cands = [ptb_tokenize(preds[i]) for i in img_ids]
    refs = [[ptb_tokenize(c) for c in gts[i]] for i in img_ids]

    # prefer the C++ n-gram core (native/ngram_scorer.cpp); the python
    # scorers are the semantic oracle and the fallback
    from dmi_tpu_torch.evals.native import cider_d_native, coco_bleu_native

    bleus = coco_bleu_native(cands, refs)
    if bleus is None:
        bleus, _ = coco_bleu(cands, refs)
    nat = cider_d_native(cands, refs)
    cider_score = nat[0] if nat is not None else cider_d(cands, refs)[0]
    # METEOR-1.5 semantics (the reference's Java jar inside COCOEvalCap,
    # dmi/utils/eval_utils.py:195-198): corpus-aggregated statistics,
    # content/function weighting — see dmi_tpu/evals/meteor15.py
    meteor_score, _, _ = meteor15_corpus(cands, refs)
    rouge_score, _ = rouge_l(cands, refs)
    return {
        "Bleu_1": bleus[0],
        "Bleu_2": bleus[1],
        "Bleu_3": bleus[2],
        "Bleu_4": bleus[3],
        "METEOR": meteor_score,
        "ROUGE_L": rouge_score,
        "CIDEr": cider_score,
    }
