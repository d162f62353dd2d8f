"""Llama-3.x causal decoder in PyTorch: the serving forward.

Counterpart of dmi_tpu/models/llama.py for the llama-3.x body only (the
reference's production LM, Llama-3.2-1B-Instruct): grouped-query attention,
Llama-3 rope scaling, f32 RMSNorm, f32 rope tables and f32 attention
softmax, tied head.  Parameters are a plain dict in the JAX package's
layout: weights (in, out), names `embed`, `layers`, `final_norm`, with
`layers` a list of per-layer dicts (the JAX package stacks them [L, ...]
for lax.scan; here a Python loop runs the layers).  `from_hf_state_dict`
reads HF llama-3.x weights into that layout.  The other decoder families
the JAX package covers are not ported yet (ROADMAP.md A.9).

Attention: prefill (T > 1) runs `_attention`, plain torch with the additive
bias; the single-token cache step runs the CUDA decode-attention kernel
(ops/cuda/decode_attn.py), or its plain twin when `plain` is set.  The
full-sequence `forward` of training and the eval loss runs the CUDA flash
attention kernels, forward and backward (ops/cuda/flash_attn.py), or their
plain twin when `plain` is set.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dmi_tpu_torch.models.quant import int_matmul, quantize_act, unpack_w4
from dmi_tpu_torch.ops.cuda.decode_attn import _decode_attn_plain, fused_decode_attention
from dmi_tpu_torch.ops.cuda.flash_attn import _flash_attn_plain, flash_attention


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


# the port's per-layer names and the HF llama keys under model.layers.{i}.;
# Linear weights transpose from HF's (out, in) to (in, out), norms do not
_HF_LAYER_KEYS = {
    "wq": ("self_attn.q_proj.weight", True), "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True), "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True), "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "ln_attn": ("input_layernorm.weight", False),
    "ln_mlp": ("post_attention_layernorm.weight", False),
}


def from_hf_state_dict(state_dict, cfg: LlamaConfig, device="cpu") -> dict:
    """An HF LlamaForCausalLM state dict (llama-3.x layout, tied head) ->
    the parameters `init` makes, in cfg.dtype on `device` (dmi_tpu's
    from_hf_state_dict for this layout, per-layer lists in place of [L, ...]
    stacks).  A tensor already in cfg.dtype keeps its bits.  A key of
    another family (q/k/v biases, q/k norms, gemma's extra norms, MoE, MLA,
    an untied lm_head) is refused; an lm_head.weight equal to the embedding
    is the tied head saved twice (.bin files) and is accepted."""
    keys = set(state_dict)
    per_layer = {f"model.layers.{i}.{hf}": (i, name, transpose)
                 for i in range(cfg.num_hidden_layers)
                 for name, (hf, transpose) in _HF_LAYER_KEYS.items()}
    top = {"model.embed_tokens.weight", "model.norm.weight"}
    missing = sorted((top | set(per_layer)) - keys)
    if missing:
        raise KeyError(f"the HF state dict lacks {missing[:8]} ({len(missing)} keys)")
    head = state_dict.get("lm_head.weight")
    extra = sorted(keys - top - set(per_layer) - {"lm_head.weight"})
    if head is not None and not torch.equal(head, state_dict["model.embed_tokens.weight"]):
        extra.append("lm_head.weight (differs from the tied embedding)")
    if extra:
        raise NotImplementedError(
            f"HF keys of another decoder family: {extra[:8]} ({len(extra)} keys); only the "
            "llama-3.x layout is ported (ROADMAP.md A.9, decoder families)")

    def get(key, transpose=False):
        t = state_dict[key].to(device=device, dtype=cfg.dtype)
        return (t.t() if transpose else t).contiguous()

    layers = [{} for _ in range(cfg.num_hidden_layers)]
    for key, (i, name, transpose) in per_layer.items():
        layers[i][name] = get(key, transpose)
    return {"embed": get("model.embed_tokens.weight"), "layers": layers,
            "final_norm": get("model.norm.weight")}


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
    """Embedding rows; a quantized embed ({"q"|"q8", "s" [V, 1]}) gathers
    int8 rows and rescales them by their row scales in cfg.dtype."""
    embed = params["embed"]
    if isinstance(embed, dict):
        qk = "q8" if "q8" in embed else "q"
        return embed[qk][input_ids].to(cfg.dtype) * embed["s"][input_ids].to(cfg.dtype)
    return embed[input_ids]


def _mm(h: torch.Tensor, w) -> torch.Tensor:
    """h [..., in] @ w [in, out], dispatching on the quantized weight dicts
    of models/quant.py (dmi_tpu's llama._mm): h @ (q * s) == (h @ q) * s
    with per-output-column scales.  "q8" and "qp" weights quantize the
    activations per token and take the exact integer product
    (quant.int_matmul), rescaled by both factors in dmi_tpu's order.  This
    is the prefill's form; the decode loop's is decode._mm_bl."""
    if not isinstance(w, dict):
        return h @ w
    if "q8" in w:
        hq, a = quantize_act(h, axis=-1)
        return (int_matmul(hq, w["q8"]) * a * w["s"]).to(h.dtype)
    if "qp" in w:
        hq, a = quantize_act(h, axis=-1)
        q8 = unpack_w4(w["qp"])
        if "s4g" in w:
            # grouped scales: G partial products, each weighted by its
            # group's scales, then summed
            s4g = w["s4g"]
            G, K = s4g.shape[-2], q8.shape[-2]
            hg = hq.reshape(*hq.shape[:-1], G, 1, K // G)
            qg = q8.reshape(G, K // G, q8.shape[-1])
            acc = int_matmul(hg, qg).squeeze(-2)  # [..., G, out]
            return ((acc * s4g).sum(dim=-2) * a).to(h.dtype)
        return (int_matmul(hq, q8) * a * w["s"]).to(h.dtype)
    if "q" in w:
        return (h @ w["q"].to(h.dtype)) * w["s"].to(h.dtype)
    raise ValueError(f"unknown quantized dict keys {sorted(w)}")


def _head_matmul(x: torch.Tensor, params: dict, cfg: LlamaConfig) -> torch.Tensor:
    """Tied head: logits = x @ embed.T (a transposed view, no copy); a
    quantized embed's per-row scales are the head's output-channel scales."""
    embed = params["embed"]
    if isinstance(embed, dict) and "q8" in embed:
        hq, a = quantize_act(x, axis=-1)
        return (int_matmul(hq, embed["q8"].t()) * a * embed["s"][:, 0]).to(x.dtype)
    if isinstance(embed, dict):
        return (x @ embed["q"].to(x.dtype).t()) * embed["s"].to(x.dtype)[:, 0]
    return x @ embed.t()


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


def _write_cache(cache_kv, cache_index: int, k, v):
    """Write k/v [B, nkv, T, hd] into the caches at cache_index, in place;
    return views of the caches' written positions."""
    k_cache, v_cache = cache_kv
    end = cache_index + k.shape[2]
    k_cache[:, :, cache_index:end] = k
    v_cache[:, :, cache_index:end] = v
    return k_cache[:, :, :end], v_cache[:, :, :end]


def _block(cfg: LlamaConfig, x, lw, cos, sin, bias, cache_kv=None, cache_index: int = 0,
           plain: bool = False, key_mask=None):
    """One transformer block over x [B, T, H] with this layer's weights lw.

    With cache_kv = (k_cache, v_cache) [B, nkv, S_max, hd] (serving), the
    new k/v are written IN PLACE into the caches at cache_index, and
    attention reads the caches' first cache_index + T positions; bias is
    [T, cache_index + T] f32.  T == 1 is a decode step: the CUDA kernel (its
    plain twin when `plain`).

    With cache_kv None (training and the eval loss), attention is causal
    over x's T positions with the keys masked by key_mask [B, T] (None: no
    key masked), through the flash attention kernels (the twin when
    `plain`); bias is unused.  Nothing on this path is written in place."""
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

    scale = attn_score_scale(cfg)
    cap = cfg.attn_logit_softcap
    if cache_kv is None:
        attend = _flash_attn_plain if plain else flash_attention
        attn = attend(q, k, v, key_mask, scale)
    elif T == 1:
        k, v = _write_cache(cache_kv, cache_index, k, v)
        attend = _decode_attn_plain if plain else fused_decode_attention
        attn = attend(q.contiguous(), k, v, bias[0], scale, cap)
    else:
        k, v = _write_cache(cache_kv, cache_index, k, v)
        attn = _attention(q, k, v, bias, scale, cap)
    attn = attn.transpose(1, 2).reshape(B, T, nh * hd)
    x = x + _mm(attn, lw["wo"])

    h = rms_norm(x, lw["ln_mlp"], cfg.rms_norm_eps)
    if "w_gu" in lw:  # fused layout
        gate, up = _mm(h, lw["w_gu"]).chunk(2, dim=-1)
    else:
        gate, up = _mm(h, lw["w_gate"]), _mm(h, lw["w_up"])
    return x + _mm(mlp_activation(cfg, gate) * up, lw["w_down"])


def forward(cfg: LlamaConfig, params: dict, inputs_embeds: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None, plain: bool = False) -> torch.Tensor:
    """Full-sequence forward with no cache -> logits [B, T, V] (dmi_tpu's
    llama.forward on the flash path, llama.py:1255-1379).

    attention_mask: [B, T] with 1 = real token (HF convention), or None for
    pure causal attention.  As on the TPU flash path it masks keys only:
    pad queries still attend the real prefix (llama.py:1089-1095).
    Positions are arange(T).  Attention runs the CUDA flash kernels for
    CUDA tensors, and their plain twin for CPU tensors or when `plain`."""
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError(
            "attention softcaps in the full-sequence forward (the flash kernels "
            "have none) are not ported yet (ROADMAP.md A.9, decoder families)"
        )
    T = inputs_embeds.shape[1]
    x = scale_embeds(cfg, inputs_embeds.to(cfg.dtype))
    cos, sin = rope_tables(cfg, torch.arange(T, device=x.device))
    for lw in params["layers"]:
        x = _block(cfg, x, lw, cos, sin, None, plain=plain, key_mask=attention_mask)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _head_matmul(x, params, cfg)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """HF CausalLM loss: shift, ignore -100, token-mean cross-entropy in f32
    (dmi_tpu's llama.causal_lm_loss); 0 when no label is valid."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    nll = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                          shift_labels.reshape(-1), ignore_index=-100, reduction="sum")
    return nll / valid.sum().clamp(min=1)


def causal_lm_loss_grouped(logits: torch.Tensor, labels: torch.Tensor,
                           groups: int) -> torch.Tensor:
    """causal_lm_loss of G stacked micro-batches in one [G*B, T] forward ->
    [G] per-group token-mean losses, each equal to causal_lm_loss on that
    group's rows alone (dmi_tpu's llama.causal_lm_loss_grouped).  Rows padded
    past their own micro-batch length must carry -100 labels."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    nll = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                          shift_labels.reshape(-1), ignore_index=-100, reduction="none")
    gb, t = shift_labels.shape
    nll = nll.reshape(groups, gb // groups * t).sum(1)
    return nll / valid.reshape(groups, -1).sum(1).clamp(min=1)
