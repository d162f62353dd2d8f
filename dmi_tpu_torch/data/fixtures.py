# Copy of dmi_tpu/data/fixtures.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Synthetic dataset fixture generator.

Writes reference-schema data directories (SURVEY.md §4's "fake encoder pkl
fixture"): `{split}_embs_{enc}.pkl` dicts, gte-modernbert text-embedding
pkls, instruction-prefix pkls, COCO-format annotation JSONs for the CIDEr
harness, the karpathy-style sydney JSON and the chebi TSV — so the full
train -> decode -> metrics -> results-JSON path runs end-to-end with no
real data or network.  Schemas match dmi/data/base.py:159-185,
dmi/utils/eval_utils.py:100-135,183-207.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from dmi_tpu_torch.registry import DatasetSpec, dataset_spec

CAPTION_BANK = [
    "a dog runs on green grass near the water",
    "two people walk along a sandy beach by the ocean",
    "an industrial area with many buildings and roads",
    "a residential area with dense houses and trees",
    "a spiral galaxy with a bright central bulge",
    "an elliptical smooth round galaxy",
    "the molecule is an organic acid with a carboxyl group",
    "it is a conjugate base of a weak acid",
]

PREFIX_BANK = {
    "image": ["Caption the image", "Describe the image"],
    "audio": ["Caption the audio", "Describe the audio"],
    "video": ["Describe the video", "Caption the video"],
    "satellite": ["Describe the satellite image", "Caption the satellite image"],
    "galaxy": ["Describe the galaxy in the image", "Caption the galaxy"],
    "molecule": ["Describe the molecule ", "Caption the molecule "],
}


def _make_ids(spec: DatasetSpec, n_items: int, split: str) -> List[str]:
    base = {"train": 0, "validation": 10_000, "test": 20_000}[split]
    ids = []
    for i in range(n_items):
        if spec.name == "chebi20":
            ids.append(f"{base + i}")
        elif spec.name == "candels":
            # three-part ids normalize to 'a_b' (dmi/utils/eval_utils.py:144-146)
            for k in range(spec.caps_per_image):
                ids.append(f"gal_{base + i}_{k}")
        elif spec.subsample == "baseid":
            for k in range(spec.caps_per_image):
                ids.append(f"{base + i}_{k}")
        else:
            ids.append(f"{base + i}_0_{i % 7}" if spec.text_emb_key == "int_first" else f"id{base + i}")
    return ids


def _norm_img_id(image_id: str) -> str:
    parts = image_id.split("_")
    if len(parts) in (1, 2):
        return parts[0]
    return f"{parts[0]}_{parts[1]}"


def generate_dataset(
    data_root: str,
    name: str,
    enc_name,  # str or list[str]: one pkl per encoder, same items/captions
    mm_dim: int = 64,
    n_train: int = 32,
    n_eval: int = 8,
    text_dim: int = 64,
    seed: int = 0,
    splits: Optional[Sequence[str]] = None,
) -> None:
    spec = dataset_spec(name)
    enc_names = [enc_name] if isinstance(enc_name, str) else list(enc_name)
    rng = np.random.default_rng(seed)
    ddir = osp.join(data_root, spec.path)
    os.makedirs(ddir, exist_ok=True)
    os.makedirs(osp.join(data_root, "prefixes"), exist_ok=True)

    if splits is None:
        splits = ["train", "validation"] + (["test"] if spec.has_test_split else [])

    # instruction-prefix pkl (shared per modality)
    if spec.prefix_pkl is not None:
        prefixes = PREFIX_BANK[spec.modality.value]
        pdict = {p: rng.normal(size=(text_dim,)).astype(np.float32) for p in prefixes}
        with open(osp.join(data_root, "prefixes", spec.prefix_pkl), "wb") as f:
            pickle.dump(pdict, f)

    all_split_ids: Dict[str, List[str]] = {}
    gts: Dict[str, Dict[str, List[str]]] = {}
    for split in splits:
        n_items = n_train if split == "train" else n_eval
        ids = _make_ids(spec, n_items, split)
        split_dicts = {e: {} for e in enc_names}
        text_dict = {}
        split_gts: Dict[str, List[str]] = {}
        for j, item_id in enumerate(ids):
            caption = CAPTION_BANK[(j + len(split)) % len(CAPTION_BANK)]
            for e in enc_names:
                emb = rng.normal(size=(mm_dim,)).astype(np.float32)
                if spec.emb_index is not None:
                    emb = emb[None, :].repeat(2, axis=0)  # leading axis; [0] at load
                value = {"caption": caption, spec.emb_key: emb}
                if spec.has_smiles:
                    value["smiles"] = "C" * ((j % 3) + 1) + "O"
                split_dicts[e][item_id] = value
            key = (
                (int(item_id.split("_")[0]), caption)
                if spec.text_emb_key == "int_first"
                else (item_id, caption)
            )
            text_dict[key] = rng.normal(size=(text_dim,)).astype(np.float32)
            split_gts.setdefault(_norm_img_id(item_id), []).append(caption)

        for e in enc_names:
            with open(osp.join(ddir, f"{split}_embs_{e}.pkl"), "wb") as f:
                pickle.dump(split_dicts[e], f)
        with open(osp.join(ddir, f"{split}_embs_gte-modernbert-base.pkl"), "wb") as f:
            pickle.dump(text_dict, f)
        all_split_ids[split] = ids
        gts[split] = split_gts

    # ground-truth artifacts for the eval harness
    if spec.name == "sydney":
        images = []
        for split in splits:
            ksplit = {"validation": "val"}.get(split, split)
            for img_id, caps in gts[split].items():
                images.append(
                    {
                        "split": ksplit,
                        "imgid": int(img_id),
                        "sentences": [{"raw": c + " ."} for c in caps],
                    }
                )
        with open(osp.join(ddir, "dataset_sydney.json"), "w") as f:
            json.dump({"images": images}, f)
    elif spec.name == "chebi20":
        for split in splits:
            lines = ["CID\tSMILES\tdescription"]
            for img_id, caps in gts[split].items():
                lines.append(f"{img_id}\tCCO\t{caps[0]}")
            with open(osp.join(ddir, f"chebi_{split}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")

    # COCO-format annotations for candels & sydney (calc_cider inputs,
    # dmi/utils/eval_utils.py:195)
    if spec.name in ("candels", "sydney"):
        for split in splits:
            ksplit = {"validation": "validation" if spec.name == "candels" else "val"}.get(
                split, split
            )
            images, annotations = [], []
            ann_id = 0
            for img_id, caps in gts[split].items():
                images.append({"id": img_id})
                for c in caps:
                    annotations.append({"image_id": img_id, "id": ann_id, "caption": c})
                    ann_id += 1
            with open(
                osp.join(ddir, f"{spec.name}_{ksplit}_annotations.json"), "w"
            ) as f:
                json.dump(
                    {
                        "images": images,
                        "annotations": annotations,
                        "type": "captions",
                        "info": {},
                        "licenses": [],
                    },
                    f,
                )
