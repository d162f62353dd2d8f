# Copy of dmi_tpu/data/loader.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Unified dataset loader driven by registry.DatasetSpec.

Replaces the reference's nine loader subclasses + BaseLoader
(dmi/data/base.py and dmi/data/<dataset>.py) with one implementation whose
behavior switches come from the declarative spec.  Pipeline order matches
the reference exactly (SURVEY.md §7 hard part 5):

    load pkl -> subsample -> InfFS feature selection -> running mean ->
    (per batch) select features -> subtract mean -> tokenize -> collate

Embedding L2 normalization happens later, on device, in the embedding
manager (dmi_tpu/training/embeddings.py), matching the reference's split of
responsibilities (dmi/utils/model_utils.py:47-62).

Host/batch design for TPU: batches are numpy dicts; tokenization runs on
host per batch (random instruction prefixes force that, as in the
reference) and overlaps device compute through JAX async dispatch.  Padded
lengths are bucketed (pad_to_multiple_of) so jitted steps see a bounded
shape set.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

# HF fast (Rust) tokenizers are not thread-safe ("Already borrowed"); the
# batch prefetcher tokenizes in a worker thread while eval/generate may
# tokenize/decode on the main thread — serialize every tokenizer call.
TOKENIZER_LOCK = threading.RLock()

from dmi_tpu_torch.config import TrainArgs
from dmi_tpu_torch.data.collator import collate_chat_batch
from dmi_tpu_torch.data.inffs import select_features
from dmi_tpu_torch.data.sampler import InfiniteSampler
from dmi_tpu_torch.registry import DatasetSpec


class Split:
    """Column-oriented split storage."""

    def __init__(self, ids, captions, embs, smiles=None, text_embs=None):
        self.ids: List[str] = ids
        self.captions: List[str] = captions
        self.embs: np.ndarray = embs  # [N, ...]
        self.smiles: Optional[List[str]] = smiles
        self.text_embs: Optional[np.ndarray] = text_embs

    def __len__(self):
        return len(self.ids)

    def take(self, idxs) -> "Split":
        return Split(
            [self.ids[i] for i in idxs],
            [self.captions[i] for i in idxs],
            self.embs[idxs],
            [self.smiles[i] for i in idxs] if self.smiles is not None else None,
            self.text_embs[idxs] if self.text_embs is not None else None,
        )


class DatasetLoader:
    def __init__(
        self,
        spec: DatasetSpec,
        tokenizer,
        train_args: TrainArgs,
        model_name: str,
        is_instruct: bool,
        data_root: str = "data",
    ):
        self.spec = spec
        self.tokenizer = tokenizer
        self.train_args = train_args
        self.model_name = model_name  # encoder basename, e.g. RemoteCLIP-RN50-Unchanged
        self.is_instruct = is_instruct
        self.data_root = data_root
        self.path = osp.join(data_root, spec.path)
        self.dataset_name = spec.name
        self.max_new_tokens = spec.max_new_tokens
        self.bucket = max(1, train_args.pad_to_multiple_of)

        self.selected_features: Optional[np.ndarray] = None
        self.emb_mean: Optional[np.ndarray] = None
        self.text_emb_mean: Optional[np.ndarray] = None

        self.train = self._init_split("train")
        self.eval = self._init_split("validation")
        self.test = self._init_split("test") if spec.has_test_split else None

        if train_args.debug:
            # reference debug truncation (dmi/data/base.py:192-195)
            self.train = self.train.take(
                range(min(len(self.train), 4 * train_args.train_batch_size))
            )
            self.eval = self.eval.take(
                range(min(len(self.eval), 4 * train_args.eval_batch_size))
            )
            if self.test is not None:
                self.test = self.test.take(
                    range(min(len(self.test), 4 * train_args.eval_batch_size))
                )

        if spec.prefix_pkl is not None:
            with open(osp.join(data_root, "prefixes", spec.prefix_pkl), "rb") as f:
                self.prefix_emb_dict = pickle.load(f)
            self.prefixes = list(self.prefix_emb_dict.keys())
            self.PREFIX = None
        else:
            self.prefix_emb_dict = None
            self.prefixes = None
            self.PREFIX = spec.fixed_prefix

        self._pretok = None
        if spec.pretokenize:
            self._pretok = {
                "train": self._tokenize(self.train, self.PREFIX),
                "validation": self._tokenize(self.eval, self.PREFIX),
            }

    # ------------------------------------------------------------------
    # split loading
    # ------------------------------------------------------------------

    def _load_pkl(self, split):
        with open(
            osp.join(self.path, f"{split}_embs_{self.model_name}.pkl"), "rb"
        ) as f:
            return pickle.load(f)

    def _load_text_pkl(self, split):
        with open(
            osp.join(self.path, f"{split}_embs_gte-modernbert-base.pkl"), "rb"
        ) as f:
            return pickle.load(f)

    def _text_key(self, item_id: str, caption: str):
        if self.spec.text_emb_key == "int_first":
            return (int(item_id.split("_")[0]), caption)
        return (item_id, caption)  # 'full_id' and 'item_id' coincide here

    def _columnar_cache_path(self, split: str) -> str:
        return osp.join(self.path, f".cache_{split}_{self.model_name}.npz")

    def _load_columns(self, split: str):
        """Columnar load with an .npz sidecar cache: the reference re-parses
        the (potentially GB-scale) pickles for every seed of every sweep
        point; the first load here converts to arrays and later runs mmap
        them in milliseconds.  Invalidated by the pkl's mtime."""
        import json as _json

        pkl_path = osp.join(self.path, f"{split}_embs_{self.model_name}.pkl")
        cache = self._columnar_cache_path(split)
        if osp.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(pkl_path):
            z = np.load(cache, allow_pickle=False)
            meta = _json.loads(str(z["meta"]))
            return meta["ids"], meta["captions"], z["embs"], meta.get("smiles")

        raw = self._load_pkl(split)
        ids, captions, embs, smiles = [], [], [], []
        for key, value in raw.items():
            ids.append(key)
            captions.append(value["caption"])
            e = np.asarray(value[self.spec.emb_key], np.float32)
            if self.spec.emb_index is not None:
                e = e[self.spec.emb_index]
            embs.append(e)
            if self.spec.has_smiles:
                smiles.append(value["smiles"])
        embs = np.stack(embs) if embs else np.zeros((0, 0), np.float32)
        meta = {"ids": ids, "captions": captions}
        if self.spec.has_smiles:
            meta["smiles"] = smiles
        try:
            np.savez(cache, embs=embs, meta=_json.dumps(meta))
        except OSError:
            pass  # read-only data dir: skip caching
        return ids, captions, embs, smiles if self.spec.has_smiles else None

    def _init_split(self, split: str) -> Split:
        ids, captions, embs, smiles = self._load_columns(split)
        text_raw = self._load_text_pkl(split) if self.train_args.feed_txt_embs else None

        ds = self.train_args.dataset_size
        if split == "train" and ds is not None and ds != "full":
            size = int(ds)
            if self.spec.subsample == "baseid":
                # keep whole caption groups (dmi/data/base.py:139-157);
                # columns preserve the pkl's insertion order
                baseids = set()
                for cur_id in ids:
                    if len(baseids) <= size // self.spec.caps_per_image:
                        baseids.add(cur_id.split("_")[0])
                keep = [i for i, k in enumerate(ids) if k.split("_")[0] in baseids]
                keep = keep[:size]
            else:  # 'shuffle' (dmi/data/coco.py:124-126, HF datasets.shuffle)
                if self.spec.clamp_dataset_size:
                    size = min(size, len(ids))
                perm = np.random.default_rng(self.train_args.seed).permutation(len(ids))
                keep = list(perm[:size])
            ids = [ids[i] for i in keep]
            captions = [captions[i] for i in keep]
            embs = embs[np.asarray(keep, np.int64)] if len(keep) else embs[:0]
            if smiles is not None:
                smiles = [smiles[i] for i in keep]

        text_embs = None
        if text_raw is not None:
            text_embs = np.stack(
                [
                    np.asarray(text_raw[self._text_key(k, c)], np.float32)
                    for k, c in zip(ids, captions)
                ]
            ) if ids else None
        split_obj = Split(ids, captions, embs, smiles, text_embs)

        if split == "train":
            if self.train_args.n_components is not None:
                # InfFS runs on the subsampled raw embeddings
                # (dmi/data/base.py:100-104,172-173)
                self.selected_features = select_features(
                    embs, self.train_args.n_components
                )
            if self.train_args.subtract_mean and len(split_obj):
                # true running mean (see note: the reference's base-loader
                # variant degenerates to an EMA due to a non-incremented
                # counter, dmi/data/base.py:112-126; the coco-style loaders
                # compute the true mean — we use the true mean everywhere;
                # no shipped config enables subtract_mean)
                self.emb_mean = embs.mean(axis=0, keepdims=True)
                if split_obj.text_embs is not None:
                    self.text_emb_mean = split_obj.text_embs.mean(axis=0, keepdims=True)
        return split_obj

    # ------------------------------------------------------------------
    # tokenization
    # ------------------------------------------------------------------

    def _chat(self, prefix: str, caption: str, smiles: Optional[str]):
        user = f"{prefix}{smiles}" if smiles is not None else prefix
        return [
            {"role": "user", "content": user},
            {"role": "assistant", "content": caption},
        ]

    def _tokenize(self, split: Split, prefix: str):
        with TOKENIZER_LOCK:
            if self.is_instruct:
                chats = [
                    self._chat(prefix, cap, split.smiles[i] if split.smiles else None)
                    for i, cap in enumerate(split.captions)
                ]
                return self.tokenizer.apply_chat_template(
                    chats,
                    tokenize=True,
                    return_dict=True,
                    return_assistant_tokens_mask=True,
                    add_generation_prompt=False,
                )
            return self.tokenizer(split.captions)

    def pick_prefix(self, step: int = 0) -> str:
        """Random instruction prefix, stateless in (seed, step) so a resumed
        run replays the same prefix sequence (the reference draws from the
        global python RNG, dmi/data/base.py:206 — unreproducible)."""
        if self.PREFIX is not None:
            return self.PREFIX
        rng = np.random.default_rng((self.train_args.seed, 0xB0, step))
        return self.prefixes[int(rng.integers(len(self.prefixes)))]

    def _tokenize_rows(self, split: Split, idxs, prefix: str):
        with TOKENIZER_LOCK:
            if self.is_instruct:
                chats = [
                    self._chat(
                        prefix,
                        split.captions[i],
                        split.smiles[i] if split.smiles else None,
                    )
                    for i in idxs
                ]
                return self.tokenizer.apply_chat_template(
                    chats,
                    tokenize=True,
                    return_dict=True,
                    return_assistant_tokens_mask=True,
                    add_generation_prompt=False,
                )
            return self.tokenizer([split.captions[i] for i in idxs])

    # ------------------------------------------------------------------
    # collates
    # ------------------------------------------------------------------

    def _embs_for(self, split: Split, idxs) -> np.ndarray:
        e = split.embs[idxs]
        if self.selected_features is not None:
            e = e[:, self.selected_features]
        if self.train_args.subtract_mean and self.emb_mean is not None:
            e = e - self.emb_mean
        return e

    def _collate(self, split: Split, idxs, split_name: str, with_ids: bool, step: int = 0):
        if self._pretok is not None and split_name in ("train", "validation"):
            tok = self._pretok[split_name]
            sub = {
                k: [tok[k][i] for i in idxs]
                for k in (
                    ["input_ids", "assistant_masks"]
                    if self.is_instruct
                    else ["input_ids"]
                )
            }
        else:
            sub = self._tokenize_rows(split, idxs, self.pick_prefix(step))
        batch = collate_chat_batch(
            sub,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
            is_instruct=self.is_instruct,
            padding_side=self.tokenizer.padding_side,
            bucket=self.bucket,
        )
        batch["embs"] = self._embs_for(split, idxs)
        if with_ids:
            batch["ids"] = [split.ids[i] for i in idxs]
        return batch

    def subset_collate(self, split: Split, idxs, step: int = 0):
        """Conditioning-set batch (dmi/data/base.py:260-284): embeddings,
        optionally (embs, text_embs, prefix_emb) when feed_txt_embs."""
        embs = self._embs_for(split, idxs)
        if not self.train_args.feed_txt_embs:
            return embs
        prefix = self.pick_prefix(step)
        text_embs = split.text_embs[idxs]
        if self.train_args.subtract_mean and self.text_emb_mean is not None:
            text_embs = text_embs - self.text_emb_mean
        if self.prefix_emb_dict is None:
            # coco-family subset: (embs, text_embs) — no instruction-prefix
            # embedding exists (dmi/data/coco.py:166-182)
            return (embs, text_embs)
        prefix_emb = np.asarray(self.prefix_emb_dict[prefix], np.float32)[None, :]
        return (embs, text_embs, prefix_emb)

    # ------------------------------------------------------------------
    # loaders (batch iterators)
    # ------------------------------------------------------------------

    def _split_by_name(self, name: str) -> Split:
        split = {"train": self.train, "validation": self.eval, "test": self.test}[name]
        if split is None:
            # pretrain/hypernet datasets carry no test pkl; fall back to
            # validation (the reference crashes on this path — its
            # build_eval_and_test_loaders assumes test_set exists)
            return self.eval
        return split

    def train_sampler(self) -> InfiniteSampler:
        return InfiniteSampler(
            len(self.train), self.train_args.epochs or 1, self.train_args.seed
        )

    def total_train_steps(self) -> int:
        """Total optimizer micro-steps = len(torch DataLoader) in the
        reference = ceil(sampler_len / batch_size) where sampler_len is
        n_samples * epochs (dmi/train.py:75 + torch BatchSampler semantics).
        Each step consumes one full batch."""
        sampler_len = len(self.train_sampler())
        return -(-sampler_len // self.train_args.train_batch_size)

    def train_batch(self, step: int) -> Dict:
        idxs = self.train_sampler().batch_indices(step, self.train_args.train_batch_size)
        return self._collate(self.train, idxs, "train", with_ids=False, step=step)

    def subset_batch(self, step: int, split_name: str = "train"):
        split = self._split_by_name(split_name)
        sampler = InfiniteSampler(
            len(split), self.train_args.epochs or 1, self.train_args.seed + 1
        )
        idxs = sampler.batch_indices(step, self.train_args.subset_batch_size)
        return self.subset_collate(split, idxs, step=step)

    def eval_batches(self, split_name: str = "validation") -> Iterator[Dict]:
        """Sequential one-pass batches with ids (dmi/data/base.py:240-258)."""
        split = self._split_by_name(split_name)
        bsz = self.train_args.eval_batch_size
        for bi, start in enumerate(range(0, len(split), bsz)):
            idxs = list(range(start, min(start + bsz, len(split))))
            yield self._collate(split, idxs, split_name, with_ids=True, step=bi)

    def n_eval_batches(self, split_name: str = "validation") -> int:
        split = self._split_by_name(split_name)
        bsz = self.train_args.eval_batch_size
        return -(-len(split) // bsz)
