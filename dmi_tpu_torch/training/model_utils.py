"""LM/tokenizer builders (counterpart of dmi_tpu/training/model_utils.py).

  * "test:tiny[:<vocab>]" — a tiny random-config Llama + the offline
    byte-BPE tokenizer fixture
  * "test:1b[:<vocab>]" — the Llama-3.2-1B body with random weights and the
    fixture vocab (production-scale compute without HF weights)
  * anything else — a llama-3.x model in the HF layout from a local
    directory or the HF hub cache (training/hf_weights.py: config.json and
    safetensors or .bin weights, read without transformers), and its
    tokenizer through transformers.AutoTokenizer
The DMI_LM_OVERRIDE environment variable substitutes any configured name
with one of the above, as in dmi_tpu.  The other decoder families are not
ported yet (ROADMAP.md A.9): their configs and weights are refused.  The
tokenizers need transformers and tokenizers, so they are imported only
here, lazily.

`require_device` is the entry points' device check: they run on the card
unless asked for the CPU, and fail before loading anything when no card is
visible.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Tuple

import torch

from dmi_tpu_torch.models import llama
from dmi_tpu_torch.training import hf_weights

log = logging.getLogger("dmi_tpu_torch")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.bfloat16}


def require_device(device="cuda") -> torch.device:
    """The device an entry point was asked for.  Raises when that is a CUDA
    device and torch sees none: the port never falls back to the CPU, which
    runs only when asked for (device="cpu", --device cpu)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: dmi_tpu_torch's entry points run on the card; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def is_test_lm(name: str) -> bool:
    return name.startswith("test:")


def is_instruct_lm(name: str) -> bool:
    """reference: is_instruct = name in LLMS_CHATTEMPLATES
    (dmi/train_projector.py:188); test models run the instruct path."""
    if is_test_lm(name):
        return True
    from dmi_tpu_torch.chat_templates import LLMS_CHATTEMPLATES

    return name in LLMS_CHATTEMPLATES


def _resolve_name(name: str) -> str:
    """DMI_LM_OVERRIDE substitutes the LM (e.g. 'test:tiny') so that the
    literal reference configs run where their LM is absent."""
    return os.environ.get("DMI_LM_OVERRIDE") or name


def _not_ported(what: str):
    return NotImplementedError(
        f"{what}: only the llama-3.x layout (tied head, silu MLP, no biases, llama3 or "
        "no rope scaling) is ported; the other decoder families are not ported yet "
        "(ROADMAP.md A.9, decoder families)"
    )


def build_tokenizer(lm_args):
    name = _resolve_name(lm_args.lm_name_or_path)
    if is_test_lm(name):
        from dmi_tpu_torch.data.tok_fixture import build_test_tokenizer

        return build_test_tokenizer()
    from transformers import AutoTokenizer

    from dmi_tpu_torch.chat_templates import LLMS_CHATTEMPLATES

    tokenizer = AutoTokenizer.from_pretrained(str(hf_weights.model_dir(name)),
                                              local_files_only=True)
    tokenizer.pad_token = tokenizer.eos_token
    if name in LLMS_CHATTEMPLATES:
        tokenizer.chat_template = LLMS_CHATTEMPLATES[name]
    return tokenizer


def _hf_to_config(hf_cfg: dict, dtype: torch.dtype, tokenizer) -> llama.LlamaConfig:
    """The port's config for a parsed HF config.json of the llama family
    (dmi_tpu's _hf_to_config for model_type llama): a llama3 rope_scaling
    block maps onto the four rope_* fields; eos comes from the config, else
    from the tokenizer.  Absent keys take transformers.LlamaConfig's
    defaults.  What the llama-3.x body does not compute is refused."""
    family = hf_cfg.get("model_type", "llama")
    if family != "llama":
        raise _not_ported(f"model_type {family!r}")
    if not hf_cfg.get("tie_word_embeddings", False):
        raise _not_ported("tie_word_embeddings false (an untied head)")
    for bias in ("attention_bias", "mlp_bias"):
        if hf_cfg.get(bias, False):
            raise _not_ported(f"{bias} true")
    act = hf_cfg.get("hidden_act", "silu")
    if act != "silu":
        raise _not_ported(f"hidden_act {act!r}")
    rs = hf_cfg.get("rope_scaling") or {}
    rope_type = rs.get("rope_type", rs.get("type"))
    if rs and rope_type != "llama3":
        raise _not_ported(f"rope_scaling of type {rope_type!r}")
    eos = hf_cfg.get("eos_token_id", 2)
    if eos is None:
        eos = tokenizer.eos_token_id
    eos = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
    hidden, heads = hf_cfg["hidden_size"], hf_cfg["num_attention_heads"]
    return llama.LlamaConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hidden,
        intermediate_size=hf_cfg["intermediate_size"],
        num_hidden_layers=hf_cfg["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=hf_cfg.get("num_key_value_heads") or heads,
        head_dim=hf_cfg.get("head_dim") or hidden // heads,
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rope_scaling_factor=rs.get("factor") if rope_type == "llama3" else None,
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        rope_original_max_position=rs.get("original_max_position_embeddings", 8192),
        dtype=dtype,
        eos_token_ids=eos,
        bos_token_id=hf_cfg.get("bos_token_id", 1),
    )


def build_lm(lm_args, tokenizer, seed: int = 0,
             device="cpu") -> Tuple[llama.LlamaConfig, dict]:
    """(config, parameters on `device`) of the configured LM: a test model
    with weights from `seed`, or a llama-3.x model's HF weights read off
    disk (`seed` unused)."""
    name = _resolve_name(lm_args.lm_name_or_path)
    dtype = _DTYPES[lm_args.lm_dtype or "bfloat16"]
    if not is_test_lm(name):
        path = hf_weights.model_dir(name)
        log.info("loading %s from %s", name, path)
        cfg = _hf_to_config(hf_weights.read_config(path), dtype, tokenizer)
        return cfg, llama.from_hf_state_dict(hf_weights.load_state_dict(path), cfg, device)
    parts = name.split(":")
    if parts[1] not in ("1b", "tiny"):
        raise _not_ported(f"test model {name!r}")
    vocab = int(parts[2]) if len(parts) > 2 else max(512, tokenizer.vocab_size + 8)
    if parts[1] == "1b":
        cfg = dataclasses.replace(
            llama.llama32_1b(dtype),
            vocab_size=vocab,
            eos_token_ids=(tokenizer.eos_token_id,),
            bos_token_id=tokenizer.bos_token_id or 0,
            rope_scaling_factor=None,  # tiny contexts need no llama3 scaling
        )
    else:
        cfg = llama.tiny_config(
            vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
            intermediate=128, dtype=dtype, eos=(tokenizer.eos_token_id,),
        )
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, llama.init(cfg, gen, device)
