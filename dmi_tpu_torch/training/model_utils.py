"""LM/tokenizer builders (counterpart of dmi_tpu/training/model_utils.py).

  * "test:tiny[:<vocab>]", "test:tiny-<family>[:<vocab>]" (qwen2, gemma2,
    mixtral, qwen3moe, olmoe, deepseek) — a tiny random-config decoder of
    that family + the offline byte-BPE tokenizer fixture
  * "test:1b[:<vocab>]" — the Llama-3.2-1B body with random weights and the
    fixture vocab (production-scale compute without HF weights)
  * anything else — a model of one of dmi_tpu's families (llama, mistral,
    qwen2, qwen3, phi3, olmo2, granite, gemma2, gemma3_text, mixtral,
    qwen3_moe, olmoe, deepseek_v2) in the HF layout from a local directory
    or the HF hub cache (training/hf_weights.py: config.json and
    safetensors or .bin weights, read without transformers), and its
    tokenizer through transformers.AutoTokenizer
The DMI_LM_OVERRIDE environment variable substitutes any configured name
with one of the above, as in dmi_tpu.  What dmi_tpu refuses stays refused
(mixed dense/sparse stacks, deepseek's group-limited routing, olmoe's
clip_qkv), as do options outside its layouts.  The tokenizers need
transformers and tokenizers, so they are imported only here, lazily.

`require_device` is the entry points' device check: they run on the card
unless asked for the CPU, and fail before loading anything when no card is
visible.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Tuple

import torch

from dmi_tpu_torch.models import llama
from dmi_tpu_torch.training import hf_weights
from dmi_tpu_torch.utils.rng import CounterRNG

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


def _refused(what: str):
    return NotImplementedError(
        f"{what}: outside the layouts of the decoder families dmi_tpu and dmi_tpu_torch "
        f"compute ({', '.join(_FAMILIES)})"
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


# the model types and what their transformers config classes supply for
# keys a config.json leaves out (transformers 4.57: LlamaConfig,
# MistralConfig, Qwen2Config, Qwen3Config, Phi3Config, Olmo2Config,
# GraniteConfig, Gemma2Config, Gemma3TextConfig, MixtralConfig,
# Qwen3MoeConfig, OlmoeConfig, DeepseekV2Config).  dmi_tpu reads the config
# object, whose class fills them; the port reads the raw JSON.
_COMMON_DEFAULTS = {"rms_norm_eps": 1e-6, "rope_theta": 10000.0, "tie_word_embeddings": False,
                    "bos_token_id": 1, "eos_token_id": 2, "sliding_window": None}
_FAMILIES = {
    "llama": {},
    "mistral": {"sliding_window": 4096, "num_key_value_heads": 8},
    "qwen2": {"bos_token_id": None, "eos_token_id": None, "num_key_value_heads": 32,
              "max_window_layers": 28},
    "qwen3": {"bos_token_id": None, "eos_token_id": None, "num_key_value_heads": 32,
              "head_dim": 128, "max_window_layers": 28},
    "phi3": {"rms_norm_eps": 1e-5, "eos_token_id": 32000},
    "olmo2": {"rms_norm_eps": 1e-5, "bos_token_id": None, "eos_token_id": 50279},
    "granite": {"embedding_multiplier": 1.0, "attention_multiplier": 1.0,
                "residual_multiplier": 1.0, "logits_scaling": 1.0},
    "gemma2": {"tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1,
               "num_key_value_heads": 4, "head_dim": 256, "sliding_window": 4096,
               "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0},
    "gemma3_text": {"tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1,
                    "num_key_value_heads": 4, "head_dim": 256, "sliding_window": 4096,
                    "query_pre_attn_scalar": 256, "rope_theta": 1_000_000.0,
                    "rope_local_base_freq": 10000.0, "attn_logit_softcapping": None,
                    "final_logit_softcapping": None, "sliding_window_pattern": 6},
    "mixtral": {"rms_norm_eps": 1e-5, "rope_theta": 1_000_000.0, "num_key_value_heads": 8,
                "num_local_experts": 8, "num_experts_per_tok": 2},
    "qwen3_moe": {"bos_token_id": None, "eos_token_id": None, "num_key_value_heads": 4,
                  "decoder_sparse_step": 1, "mlp_only_layers": None,
                  "moe_intermediate_size": 768, "num_experts": 128, "num_experts_per_tok": 8,
                  "norm_topk_prob": False},
    "olmoe": {"rms_norm_eps": 1e-5, "bos_token_id": None, "eos_token_id": 50279,
              "num_key_value_heads": None, "clip_qkv": None, "num_experts": 64,
              "num_experts_per_tok": 8, "norm_topk_prob": False},
    "deepseek_v2": {"num_key_value_heads": None, "max_position_embeddings": 2048,
                    "first_k_dense_replace": 0, "kv_lora_rank": 512, "q_lora_rank": 1536,
                    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
                    "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": None,
                    "routed_scaling_factor": 1.0, "topk_method": "greedy",
                    "norm_topk_prob": False, "moe_intermediate_size": 1407},
}
_GEMMA = ("gemma2", "gemma3_text")


def _layer_types(family: str, c: dict):
    """HF's per-layer attention kinds, as the config classes derive them
    when config.json has no layer_types: qwen2/qwen3 slide from layer
    max_window_layers on when use_sliding_window; gemma-2 alternates from a
    sliding layer 0; gemma-3 makes every sliding_window_pattern-th layer
    full; mistral, phi-3 and mixtral slide every layer under a configured
    window (HF MistralModel / Phi3Model / MixtralModel, as dmi_tpu reads
    them); the rest have none."""
    n = c["num_hidden_layers"]
    if c.get("layer_types") is not None:
        return c["layer_types"]
    if family in ("qwen2", "qwen3"):
        if not c.get("use_sliding_window", False):
            return None
        return ["sliding_attention" if i >= c["max_window_layers"] else "full_attention"
                for i in range(n)]
    if family == "gemma2":
        return ["sliding_attention" if (i + 1) % 2 else "full_attention" for i in range(n)]
    if family == "gemma3_text":
        pattern = c["sliding_window_pattern"]
        return ["sliding_attention" if (i + 1) % pattern else "full_attention"
                for i in range(n)]
    if family in ("mistral", "phi3", "mixtral") and c.get("sliding_window"):
        return ["sliding_attention"] * n
    return None


def _hf_to_config(hf_cfg: dict, dtype: torch.dtype, tokenizer) -> llama.LlamaConfig:
    """The port's config for a parsed HF config.json (dmi_tpu's _hf_to_config
    for model_type llama, mistral, qwen2, qwen3, phi3, olmo2, granite,
    gemma2, gemma3_text, mixtral, qwen3_moe, olmoe and deepseek_v2):
    per-layer sliding flags from layer_types (or the family's own rule) and
    the window where a layer slides; llama3 or linear rope_scaling (yarn for
    deepseek_v2); qwen's q/k biases and norms, olmo2's post-norm blocks,
    granite's four multipliers, gemma's GeGLU, (1 + w) norms, post-block
    norms, softcaps, query_pre_attn_scalar and embedding normalizer (at
    lookup for gemma-3, with its local rope base); the experts, top-k and
    renormalisation of the MoE families (qwen3-moe's and deepseek's expert
    width moe_intermediate_size); deepseek's MLA widths (head_dim the q/k
    width, nkv = nh), f32 gate, routed_scaling_factor and shared experts;
    tie_word_embeddings.  Keys left out take the family's defaults
    (_FAMILIES).  eos comes from the config, else from the tokenizer.
    Refused as dmi_tpu refuses them: qwen3-moe and deepseek stacks mixing
    dense and sparse layers, deepseek's topk_method other than greedy,
    olmoe's clip_qkv and attention bias, deepseek's attention bias.  Refused
    besides, as outside the layouts: another model type, dynamic or longrope
    rope scaling (yarn outside deepseek), MLP biases, another activation,
    and the o_proj bias that attention_bias adds outside qwen."""
    family = hf_cfg.get("model_type", "llama")
    if family not in _FAMILIES:
        raise _refused(f"model_type {family!r}")
    c = {**_COMMON_DEFAULTS, **_FAMILIES[family], **hf_cfg}
    act = c.get("hidden_activation" if family in _GEMMA else "hidden_act")
    want = "gelu_pytorch_tanh" if family in _GEMMA else "silu"
    if act is not None and act != want:
        raise _refused(f"{family} with activation {act!r}")
    if c.get("mlp_bias", False):
        raise _refused("mlp_bias true")
    if c.get("attention_bias", False) and family not in ("qwen2", "qwen3", "qwen3_moe"):
        raise _refused(f"{family} with attention_bias true (an o_proj bias)")
    if family == "phi3" and c.get("partial_rotary_factor", 1.0) != 1.0:
        raise _refused("phi3 with partial_rotary_factor != 1")
    if family == "gemma3_text" and c.get("use_bidirectional_attention", False):
        raise _refused("gemma3 with bidirectional attention")
    rs = c.get("rope_scaling") or {}
    rope_type = rs.get("rope_type", rs.get("type"))
    yarn = family == "deepseek_v2" and rope_type == "yarn"
    if rs and not yarn and (rope_type not in ("llama3", "linear") or family == "phi3"):
        raise _refused(f"{family} with rope_scaling of type {rope_type!r}")

    layer_types = _layer_types(family, c)
    layer_sliding = (tuple(t == "sliding_attention" for t in layer_types)
                     if layer_types else None)
    window = c["sliding_window"] if layer_sliding and any(layer_sliding) else None
    if not window:
        layer_sliding = None
    eos = c["eos_token_id"]
    if eos is None:
        eos = tokenizer.eos_token_id
    eos = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
    hidden, heads = c["hidden_size"], c["num_attention_heads"]

    kw = {"intermediate_size": c["intermediate_size"],
          "num_key_value_heads": c.get("num_key_value_heads") or heads,
          "head_dim": c.get("head_dim") or hidden // heads,
          "rope_original_max_position": rs.get("original_max_position_embeddings", 8192)}
    if family in ("qwen2", "qwen3", "qwen3_moe"):
        kw["attention_bias"] = family == "qwen2" or bool(c.get("attention_bias", False))
        kw["qk_norm"] = family != "qwen2"
    elif family == "olmo2":
        kw.update(qk_norm_wide=True, norm_after=True)
    elif family == "granite":
        kw.update(embedding_normalizer=float(c["embedding_multiplier"]),
                  attn_scale=float(c["attention_multiplier"]),
                  residual_multiplier=float(c["residual_multiplier"]),
                  logit_scale=float(c["logits_scaling"]))
    elif family in _GEMMA:
        kw.update(mlp_act="gelu_tanh", attn_scale=float(c["query_pre_attn_scalar"]) ** -0.5,
                  attn_logit_softcap=c["attn_logit_softcapping"],
                  final_logit_softcap=c["final_logit_softcapping"],
                  embedding_normalizer=float(hidden) ** 0.5, post_block_norms=True,
                  norm_plus_one=True)
        if family == "gemma3_text":
            if not (layer_sliding and window):
                raise _refused("gemma3 without sliding layers (they select the "
                               "local-rope layers)")
            kw.update(embedding_scale_at_lookup=True, qk_norm=True,
                      rope_local_theta=float(c["rope_local_base_freq"]))
    elif family == "mixtral":
        kw.update(num_experts=int(c["num_local_experts"]),
                  num_experts_per_tok=int(c["num_experts_per_tok"]))
    elif family == "olmoe":
        if c.get("clip_qkv") is not None:
            raise _refused("olmoe with clip_qkv (dmi_tpu refuses it)")
        kw.update(qk_norm_wide=True, num_experts=int(c["num_experts"]),
                  num_experts_per_tok=int(c["num_experts_per_tok"]),
                  moe_norm_topk=bool(c["norm_topk_prob"]))
    elif family == "deepseek_v2":
        kw.update(_deepseek_fields(c, rs if yarn else None))
    if family == "qwen3_moe":
        if c["decoder_sparse_step"] != 1 or c["mlp_only_layers"]:
            raise _refused("qwen3_moe with mixed dense and sparse layers (decoder_sparse_step "
                           "!= 1 or mlp_only_layers; dmi_tpu refuses them)")
        kw.update(num_experts=int(c["num_experts"]),
                  num_experts_per_tok=int(c["num_experts_per_tok"]),
                  moe_norm_topk=bool(c["norm_topk_prob"]),
                  intermediate_size=int(c["moe_intermediate_size"]))
    return llama.LlamaConfig(
        vocab_size=c["vocab_size"],
        hidden_size=hidden,
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=heads,
        rms_norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"],
        rope_scaling_factor=rs.get("factor") if rope_type == "llama3" else None,
        rope_linear_factor=rs.get("factor") if rope_type == "linear" else None,
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        tie_word_embeddings=c["tie_word_embeddings"],
        dtype=dtype,
        eos_token_ids=eos,
        bos_token_id=c["bos_token_id"],
        sliding_window=window,
        layer_sliding=layer_sliding,
        **kw,
    )


def _deepseek_fields(c: dict, yarn) -> dict:
    """deepseek_v2's config fields (dmi_tpu's branch of _hf_to_config): MLA
    widths (head_dim the q/k width qk_nope + qk_rope, nkv = nh, interleaved
    rope), the deepseek MoE where the stack is all sparse
    (first_k_dense_replace 0 and routed experts), and yarn from its
    rope_scaling (original_max_position_embeddings, else the config's
    max_position_embeddings)."""
    L = c["num_hidden_layers"]
    fkd = int(c.get("first_k_dense_replace") or 0)
    if 0 < fkd < L:
        raise _refused(f"deepseek_v2 with mixed dense and MoE layers (first_k_dense_replace "
                       f"{fkd} of {L} layers; dmi_tpu takes 0 or >= the layer count)")
    kw = dict(q_lora_rank=c.get("q_lora_rank"), kv_lora_rank=int(c["kv_lora_rank"]),
              qk_nope_head_dim=int(c["qk_nope_head_dim"]),
              qk_rope_head_dim=int(c["qk_rope_head_dim"]), v_head_dim=int(c["v_head_dim"]),
              rope_interleaved=True,
              head_dim=int(c["qk_nope_head_dim"]) + int(c["qk_rope_head_dim"]),
              num_key_value_heads=c["num_attention_heads"])
    if fkd == 0 and c.get("n_routed_experts"):
        if c.get("topk_method", "greedy") != "greedy":
            raise _refused(f"deepseek_v2 with topk_method {c['topk_method']!r} (dmi_tpu routes "
                           "greedy only)")
        if c.get("num_experts_per_tok") is None:
            raise _refused("deepseek_v2 with routed experts and no num_experts_per_tok")
        kw.update(num_experts=int(c["n_routed_experts"]),
                  num_experts_per_tok=int(c["num_experts_per_tok"]),
                  moe_norm_topk=bool(c.get("norm_topk_prob", False)),
                  routed_scaling_factor=float(c["routed_scaling_factor"]),
                  n_shared_experts=int(c.get("n_shared_experts") or 0), moe_gate_fp32=True,
                  intermediate_size=int(c["moe_intermediate_size"]))
    if yarn is not None:
        kw.update(rope_yarn_factor=float(yarn["factor"]),
                  rope_yarn_beta_fast=float(yarn.get("beta_fast") or 32),
                  rope_yarn_beta_slow=float(yarn.get("beta_slow") or 1),
                  rope_yarn_mscale=yarn.get("mscale"),
                  rope_yarn_mscale_all_dim=yarn.get("mscale_all_dim"),
                  rope_yarn_attention_factor=yarn.get("attention_factor"),
                  rope_yarn_truncate=bool(yarn.get("truncate", True)),
                  rope_original_max_position=int(yarn.get("original_max_position_embeddings")
                                                 or c["max_position_embeddings"]))
    return kw


def build_lm(lm_args, tokenizer, seed: int = 0,
             device="cpu") -> Tuple[llama.LlamaConfig, dict]:
    """(config, parameters on `device`) of the configured LM: a test model
    with weights from `seed`, or a model's HF weights read off disk (`seed`
    unused)."""
    name = _resolve_name(lm_args.lm_name_or_path)
    dtype = _DTYPES[lm_args.lm_dtype or "bfloat16"]
    if not is_test_lm(name):
        path = hf_weights.model_dir(name)
        log.info("loading %s from %s", name, path)
        cfg = _hf_to_config(hf_weights.read_config(path), dtype, tokenizer)
        return cfg, llama.from_hf_state_dict(hf_weights.load_state_dict(path), cfg, device)
    parts = name.split(":")
    makers = {"tiny": llama.tiny_config, "tiny-qwen2": llama.tiny_qwen2_config,
              "tiny-gemma2": llama.tiny_gemma2_config,
              "tiny-mixtral": llama.tiny_mixtral_config,
              "tiny-qwen3moe": llama.tiny_qwen3moe_config,
              "tiny-olmoe": llama.tiny_olmoe_config,
              "tiny-deepseek": functools.partial(llama.tiny_deepseek_config, n_experts=4,
                                                 n_shared=1)}
    if parts[1] != "1b" and parts[1] not in makers:
        raise _refused(f"test model {name!r}")
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
        cfg = makers[parts[1]](
            vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
            intermediate=128, dtype=dtype, eos=(tokenizer.eos_token_id,),
        )
    gen = CounterRNG(seed, device=device)  # the same weights on any device
    return cfg, llama.init(cfg, gen, device)
