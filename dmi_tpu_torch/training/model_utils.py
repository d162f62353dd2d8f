"""LM/tokenizer builders (counterpart of dmi_tpu/training/model_utils.py).

  * "test:tiny[:<vocab>]" — a tiny random-config Llama + the offline
    byte-BPE tokenizer fixture
  * "test:1b[:<vocab>]" — the Llama-3.2-1B body with random weights and the
    fixture vocab (production-scale compute without HF weights)

The weights are the port's own seeded random init.  Loading a model from
the HF cache is not ported yet (ROADMAP.md A.2).  The tokenizer fixture
needs transformers and tokenizers, so it is imported only here, lazily.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dmi_tpu_torch.models import llama

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.bfloat16}


def is_test_lm(name: str) -> bool:
    return name.startswith("test:")


def _not_ported(name: str):
    return NotImplementedError(
        f"{name!r}: loading LMs from the HF cache is not ported yet; use "
        "test:tiny or test:1b (ROADMAP.md A.2)"
    )


def build_tokenizer(lm_args):
    if not is_test_lm(lm_args.lm_name_or_path):
        raise _not_ported(lm_args.lm_name_or_path)
    from dmi_tpu.data.tok_fixture import build_test_tokenizer

    return build_test_tokenizer()


def build_lm(lm_args, tokenizer, seed: int = 0,
             device="cpu") -> Tuple[llama.LlamaConfig, dict]:
    name = lm_args.lm_name_or_path
    if not is_test_lm(name):
        raise _not_ported(name)
    dtype = _DTYPES[lm_args.lm_dtype or "bfloat16"]
    parts = name.split(":")
    vocab = int(parts[2]) if len(parts) > 2 else max(512, tokenizer.vocab_size + 8)
    if parts[1] == "1b":
        cfg = dataclasses.replace(
            llama.llama32_1b(dtype),
            vocab_size=vocab,
            eos_token_ids=(tokenizer.eos_token_id,),
            bos_token_id=tokenizer.bos_token_id or 0,
            rope_scaling_factor=None,  # tiny contexts need no llama3 scaling
        )
    elif parts[1] == "tiny":
        cfg = llama.tiny_config(
            vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
            intermediate=128, dtype=dtype, eos=(tokenizer.eos_token_id,),
        )
    else:
        raise _not_ported(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, llama.init(cfg, gen, device)
