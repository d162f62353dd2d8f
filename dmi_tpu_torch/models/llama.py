"""Llama-3.x causal decoder in PyTorch: the serving forward.

Counterpart of dmi_tpu/models/llama.py for the llama-3.x body only (the
reference's production LM, Llama-3.2-1B-Instruct): grouped-query attention,
Llama-3 rope scaling, f32 RMSNorm, f32 rope tables and f32 attention
softmax, tied head.  Parameters are a plain dict in the JAX package's
layout: weights (in, out), names `embed`, `layers`, `final_norm`, with
`layers` a list of per-layer dicts (the JAX package stacks them [L, ...]
for lax.scan; here a Python loop runs the layers).  The other decoder
families the JAX package covers are not ported yet (ROADMAP.md A.9).

Attention: prefill (T > 1) runs `_attention`, plain torch with the additive
bias; the single-token cache step runs the CUDA decode-attention kernel
(ops/cuda/decode_attn.py), or its plain twin when `plain` is set.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda.decode_attn import _decode_attn_plain, fused_decode_attention


@dataclass(frozen=True)
class LlamaConfig:
    """The llama-3.x fields of dmi_tpu.models.llama.LlamaConfig, with a
    torch dtype."""

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # Llama-3 rope scaling (config.json rope_scaling{rope_type: llama3})
    rope_scaling_factor: Optional[float] = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    dtype: torch.dtype = torch.bfloat16
    # Llama-3.x instruct EOS ids: <|end_of_text|>, <|eom_id|>, <|eot_id|>
    eos_token_ids: Tuple[int, ...] = (128001, 128008, 128009)
    bos_token_id: int = 128000
    attn_scale: Optional[float] = None         # score multiplier; None -> head_dim**-0.5
    attn_logit_softcap: Optional[float] = None  # cap * tanh(score / cap)


# dmi_tpu LlamaConfig fields of the other decoder families.  A config that
# sets any of them away from its default is refused (bridge.config_from_jax).
UNPORTED_FIELDS = {
    "tie_word_embeddings": "untied heads",
    "attention_bias": "qkv biases",
    "mlp_act": "non-silu MLPs",
    "final_logit_softcap": "final-logit softcaps",
    "embedding_normalizer": "embedding scales",
    "embedding_scale_at_lookup": "embedding scales",
    "post_block_norms": "post-block norms",
    "norm_plus_one": "(1 + w) norms",
    "norm_after": "post-norm blocks",
    "sliding_window": "sliding windows",
    "layer_sliding": "sliding windows",
    "rope_local_theta": "dual rope",
    "rope_linear_factor": "linear rope scaling",
    "qk_norm": "qk-norm",
    "qk_norm_wide": "qk-norm",
    "residual_multiplier": "granite multipliers",
    "logit_scale": "granite multipliers",
    "num_experts": "MoE",
    "num_experts_per_tok": "MoE",
    "moe_norm_topk": "MoE",
    "routed_scaling_factor": "MoE",
    "n_shared_experts": "MoE",
    "moe_gate_fp32": "MoE",
    "q_lora_rank": "MLA",
    "kv_lora_rank": "MLA",
    "qk_nope_head_dim": "MLA",
    "qk_rope_head_dim": "MLA",
    "v_head_dim": "MLA",
    "rope_interleaved": "MLA",
    "rope_yarn_factor": "yarn rope scaling",
    "rope_yarn_beta_fast": "yarn rope scaling",
    "rope_yarn_beta_slow": "yarn rope scaling",
    "rope_yarn_mscale": "yarn rope scaling",
    "rope_yarn_mscale_all_dim": "yarn rope scaling",
    "rope_yarn_attention_factor": "yarn rope scaling",
    "rope_yarn_truncate": "yarn rope scaling",
}


def llama32_1b(dtype=torch.bfloat16) -> LlamaConfig:
    """meta-llama/Llama-3.2-1B-Instruct (HF config.json)."""
    return LlamaConfig(dtype=dtype)


def tiny_config(
    vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
    intermediate=128, dtype=torch.float32, eos=(5,),
) -> LlamaConfig:
    """Small random config for tests without HF weights (dmi_tpu's
    tiny_config)."""
    return LlamaConfig(
        vocab_size=vocab_size, hidden_size=hidden_size,
        intermediate_size=intermediate, num_hidden_layers=n_layers,
        num_attention_heads=n_heads, num_key_value_heads=n_kv,
        head_dim=hidden_size // n_heads, dtype=dtype, eos_token_ids=eos,
        rope_scaling_factor=None, bos_token_id=0,
    )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init(cfg: LlamaConfig, generator: torch.Generator, device="cpu") -> dict:
    """Random init: weights normal(0, 0.02) drawn in f32 from `generator`
    (which must live on `device`) and cast to cfg.dtype; norms are ones."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def w(*shape):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * 0.02).to(cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    layers = [
        {
            "wq": w(H, nh * hd), "wk": w(H, nkv * hd), "wv": w(H, nkv * hd),
            "wo": w(nh * hd, H),
            "w_gate": w(H, I), "w_up": w(H, I), "w_down": w(I, H),
            "ln_attn": ones(H), "ln_mlp": ones(H),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    return {"embed": w(cfg.vocab_size, H), "layers": layers, "final_norm": ones(H)}


def fuse_projections(params: dict) -> dict:
    """Concatenate wq|wk|wv -> w_qkv and w_gate|w_up -> w_gu in every layer
    (fewer, wider matmuls per decode step).  Idempotent."""
    layers = []
    for lw in params["layers"]:
        lw = dict(lw)
        if "wk" in lw:
            lw["w_qkv"] = torch.cat([lw.pop("wq"), lw.pop("wk"), lw.pop("wv")], dim=-1)
        if "w_gate" in lw:
            lw["w_gu"] = torch.cat([lw.pop("w_gate"), lw.pop("w_up")], dim=-1)
        layers.append(lw)
    return {**params, "layers": layers}


# ---------------------------------------------------------------------------
# Rope
# ---------------------------------------------------------------------------

def rope_inv_freq(cfg: LlamaConfig, device="cpu") -> torch.Tensor:
    """Base inverse frequencies with Llama-3 wavelength-dependent scaling
    (HF modeling_rope_utils._compute_llama3_parameters semantics), f32."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    )
    if cfg.rope_scaling_factor is None:
        return inv_freq
    factor = cfg.rope_scaling_factor
    low_wl = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wl = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
    )
    return torch.where(
        wavelen > low_wl,
        inv_freq / factor,
        torch.where(
            wavelen < high_wl,
            inv_freq,
            (1 - smooth) * inv_freq / factor + smooth * inv_freq,
        ),
    )


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*, head_dim] in f32 (HF duplicates freqs: cat(f, f))."""
    inv = rope_inv_freq(cfg, positions.device)
    freqs = positions[..., None].to(torch.float32) * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, n, T, hd]; cos/sin: [T, hd]; computed in f32."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def scale_embeds(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Identity for llama-3.x (gemma's embedding normalizer is a family
    feature not ported yet); kept so the decode code reads as dmi_tpu's."""
    return x


def embed_tokens(cfg: LlamaConfig, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def _mm(h: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized weights are not ported yet (ROADMAP.md A.5, quantized serving)"
        )
    return h @ w


def _head_matmul(x: torch.Tensor, params: dict, cfg: LlamaConfig) -> torch.Tensor:
    """Tied head: logits = x @ embed.T (a transposed view, no copy)."""
    return _mm(x, params["embed"].t())


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mlp_activation(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def attn_score_scale(cfg: LlamaConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else float(cfg.head_dim) ** -0.5


def _attention(q, k, v, bias, scale=None, softcap=None):
    """q: [B,nh,T,hd], k/v: [B,nkv,S,hd], bias [T, S] f32 -> [B,nh,T,hd];
    products in the input dtype, f32 softmax (dmi_tpu's _attention)."""
    B, nh, T, hd = q.shape
    nkv = k.shape[1]
    q = q.reshape(B, nkv, nh // nkv, T, hd)
    scores = torch.einsum("bkgtd,bksd->bkgts", q, k).float()
    scores = scores * (scale if scale is not None else 1.0 / math.sqrt(hd))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, v)
    return out.reshape(B, nh, T, hd)


def _block(cfg: LlamaConfig, x, lw, cos, sin, bias, cache_kv, cache_index: int,
           plain: bool = False):
    """One transformer block over x [B, T, H] with this layer's weights lw.

    The new k/v are written IN PLACE into cache_kv = (k_cache, v_cache)
    [B, nkv, S_max, hd] at cache_index, and attention reads the cache's
    first cache_index + T positions; bias is [T, cache_index + T] f32.
    T == 1 is a decode step: the CUDA kernel (its plain twin when `plain`)."""
    B, T, H = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    h = rms_norm(x, lw["ln_attn"], cfg.rms_norm_eps)
    if "w_qkv" in lw:  # fused layout (fuse_projections)
        q, k, v = torch.split(_mm(h, lw["w_qkv"]), [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = _mm(h, lw["wq"]), _mm(h, lw["wk"]), _mm(h, lw["wv"])
    q = apply_rope(q.reshape(B, T, nh, hd).transpose(1, 2), cos, sin)
    k = apply_rope(k.reshape(B, T, nkv, hd).transpose(1, 2), cos, sin)
    v = v.reshape(B, T, nkv, hd).transpose(1, 2)

    k_cache, v_cache = cache_kv
    end = cache_index + T
    k_cache[:, :, cache_index:end] = k
    v_cache[:, :, cache_index:end] = v
    k, v = k_cache[:, :, :end], v_cache[:, :, :end]

    scale = attn_score_scale(cfg)
    cap = cfg.attn_logit_softcap
    if T == 1:
        attend = _decode_attn_plain if plain else fused_decode_attention
        attn = attend(q.contiguous(), k, v, bias[0], scale, cap)
    else:
        attn = _attention(q, k, v, bias, scale, cap)
    attn = attn.transpose(1, 2).reshape(B, T, nh * hd)
    x = x + _mm(attn, lw["wo"])

    h = rms_norm(x, lw["ln_mlp"], cfg.rms_norm_eps)
    if "w_gu" in lw:  # fused layout
        gate, up = _mm(h, lw["w_gu"]).chunk(2, dim=-1)
    else:
        gate, up = _mm(h, lw["w_gate"]), _mm(h, lw["w_up"])
    return x + _mm(mlp_activation(cfg, gate) * up, lw["w_down"])
