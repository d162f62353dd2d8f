# Copy of dmi_tpu/data/stats.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Dataset statistics utilities.

max_token_length mirrors the per-loader __main__ validators the reference
uses to derive each dataset's hard-coded max_new_tokens budget
(e.g. dmi/data/sydney.py:19-47, dmi/data/chebi20.py:69-97).

Usage: python -m dmi_tpu.data.stats <dataset> <encoder-basename> [data_root]
"""

from __future__ import annotations

import pickle
import os.path as osp
from typing import List, Optional


def max_token_length(
    dataset: str,
    enc_name: str,
    tokenizer,
    data_root: str = "data",
    splits: Optional[List[str]] = None,
) -> int:
    from dmi_tpu_torch.registry import dataset_spec

    spec = dataset_spec(dataset)
    if splits is None:
        splits = ["validation"] + (["test"] if spec.has_test_split else [])
    max_len = 0
    for split in splits:
        path = osp.join(data_root, spec.path, f"{split}_embs_{enc_name}.pkl")
        with open(path, "rb") as f:
            split_dict = pickle.load(f)
        for value in split_dict.values():
            n = len(tokenizer(value["caption"])["input_ids"])
            max_len = max(max_len, n)
    return max_len


if __name__ == "__main__":
    import sys

    from dmi_tpu_torch.data.tok_fixture import build_test_tokenizer

    ds, enc = sys.argv[1], sys.argv[2]
    root = sys.argv[3] if len(sys.argv) > 3 else "data"
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("meta-llama/Llama-3.2-1B-Instruct")
    except Exception:
        tok = build_test_tokenizer()
    print(max_token_length(ds, enc, tok, root))
