# Copy of dmi_tpu/evals/metrics.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""calc_metrics dispatch — the reference's eval entry point, natively.

Replicates dmi/utils/eval_utils.py:100-207:
  * image-id normalization ('x' / 'x_y' -> 'x'; 'a_b_c' -> 'a_b')
  * per-dataset ground-truth loading: chebi TSV, sydney karpathy JSON,
    candels text-embedding pkl keys
  * chebi20 -> SciBERT-tokenized metric suite; others -> generic suite
  * candels/sydney additionally get the COCO harness (coco_cider/bleu/
    meteor/rouge) from {ds}_{split}_annotations.json
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
import string
from typing import Dict, List

from dmi_tpu_torch.evals.captions import caption_evaluate, caption_evaluate_chebi20
from dmi_tpu_torch.evals.coco_eval import coco_caption_eval


def normalize_image_ids(ids: List[str]) -> List[str]:
    out = []
    for image_id in ids:
        parts = image_id.split("_")
        if len(parts) in (1, 2):
            out.append(parts[0])
        elif len(parts) == 3:
            out.append(f"{parts[0]}_{parts[1]}")
        else:
            raise ValueError(f"Invalid image_id:'{image_id}'")
    return out


def load_chebi_gts(data_root: str, split: str) -> Dict[str, str]:
    gts = {}
    with open(osp.join(data_root, "chebi20", f"chebi_{split}.txt"), "r") as f:
        lines = [line.strip().strip(string.punctuation) for line in f][1:]
    for line in lines:
        cid, _, desc = line.split("\t")
        gts[cid] = desc
    return gts


def load_sydney_gts(data_root: str, split: str) -> Dict[str, List[str]]:
    gts = {}
    with open(osp.join(data_root, "sydney", "dataset_sydney.json"), "r") as f:
        items = json.load(f)["images"]
    for item in items:
        if item["split"] == split:
            cid = str(item["imgid"])
            gts[cid] = [s["raw"].strip(" .") for s in item["sentences"]]
    return gts


def load_candels_gts(data_root: str, split: str) -> Dict[str, List[str]]:
    gts: Dict[str, List[str]] = {}
    path = osp.join(data_root, "candels", f"{split}_embs_gte-modernbert-base.pkl")
    with open(path, "rb") as f:
        text_embs = pickle.load(f)
    for full_id, caption in text_embs.keys():
        imgid = f"{full_id.split('_')[0]}_{full_id.split('_')[1]}"
        gts.setdefault(imgid, []).append(caption)
    return gts


def calc_cider(
    preds: List[str],
    img_ids: List[str],
    dataset_name: str,
    split: str,
    data_root: str = "data",
):
    predictions = [
        {"image_id": img_id, "caption": pred} for pred, img_id in zip(preds, img_ids)
    ]
    ann = osp.join(data_root, dataset_name, f"{dataset_name}_{split}_annotations.json")
    m = coco_caption_eval(ann, predictions)
    return m["CIDEr"], m["Bleu_4"], m["METEOR"], m["ROUGE_L"]


def calc_metrics(
    preds: List[str],
    ids: List[str],
    dataset_name: str,
    experiment_id: str,
    mode: str,
    data_root: str = "data",
) -> Dict[str, float]:
    img_ids = normalize_image_ids(ids)

    if dataset_name == "chebi20":
        split = dict(eval="validation", test="test")[mode]
        gts = load_chebi_gts(data_root, split)
    elif dataset_name == "sydney":
        split = dict(eval="val", test="test")[mode]
        gts = load_sydney_gts(data_root, split)
    elif dataset_name == "candels":
        split = dict(eval="validation", test="test")[mode]
        gts = load_candels_gts(data_root, split)
    else:
        raise KeyError(f"no ground-truth source for dataset '{dataset_name}'")

    new_preds, new_gts = [], []
    for pred, img_id in zip(preds, img_ids):
        new_preds.append(pred)
        new_gts.append(gts[img_id])

    if dataset_name == "chebi20":
        metrics = caption_evaluate_chebi20(new_preds, new_gts)
    else:
        metrics = caption_evaluate(new_preds, new_gts)

    if dataset_name in ("candels", "sydney"):
        cider, bleu4, meteor_v, rouge_v = calc_cider(
            preds, img_ids, dataset_name, split, data_root
        )
        metrics["coco_cider"] = cider
        metrics["coco_bleu"] = bleu4
        metrics["coco_meteor"] = meteor_v
        metrics["coco_rouge"] = rouge_v
    return metrics
