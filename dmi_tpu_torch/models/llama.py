"""Causal decoder in PyTorch: the decoder families of dmi_tpu/models/llama.py.

One config and one parameter layout cover llama-3.x (the reference's
production LM, Llama-3.2-1B-Instruct), mistral, qwen2 (q/k/v biases),
qwen3 (per-head q/k RMSNorm), phi-3 (fused checkpoints, every layer
sliding), olmo2 (full-width q/k RMSNorm, post-norm blocks), granite (four
scalar multipliers), gemma-2 (GeGLU, (1 + w) norms folded at import,
post-block norms, attention and final softcaps, the sqrt(H) embedding
normalizer, interleaved sliding layers), gemma-3 text (gemma-2's without
the softcaps, per-head q/k norms, lookup-scaled embeddings, dual rope), the
sparse-MoE families mixtral, qwen3-moe and olmoe (a top-k softmax router
over dense-evaluated experts) and deepseek-v2 (multi-head latent attention
with interleaved, optionally yarn-scaled rope, and the deepseek MoE: an f32
gate, routed_scaling_factor, shared experts), with a tied or an untied
head: grouped-query attention, f32 RMSNorm, f32 rope tables and f32
attention softmax.  Parameters are a plain dict in the JAX package's
layout: weights (in, out), names `embed`, `layers`, `final_norm` (and
`lm_head` [H, V] when untied), with `layers` a list of per-layer dicts (the
JAX package stacks them [L, ...] for lax.scan; here a Python loop runs the
layers; an expert stack is [E, in, out]).  `from_hf_state_dict` reads HF
weights of these families into that layout.

Attention: prefill (T > 1) runs `_attention`, plain torch with the additive
bias; the single-token cache step runs the CUDA decode-attention kernel
(ops/cuda/decode_attn.py), or its plain twin when `plain` is set or the
config is MLA (its K and V widths differ; dmi_tpu attends through XLA
there).  The full-sequence `forward` of training and the eval loss runs the
CUDA flash attention kernels, forward and backward (ops/cuda/flash_attn.py),
or their plain twin when `plain` is set, exactly where dmi_tpu's
`use_flash` holds (no attention softcap, no sliding window that binds, no
dual rope, no MLA: `flash_route`); elsewhere `_attention` with the additive
bias, as dmi_tpu.  The routed MLP and MLA's products are torch ops, as
dmi_tpu computes them in XLA with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dmi_tpu_torch.models.quant import dequantize, int_matmul, quantize_act, unpack_w4
from dmi_tpu_torch.ops.cuda.decode_attn import _decode_attn_plain, fused_decode_attention
from dmi_tpu_torch.ops.cuda.flash_attn import _flash_attn_plain, flash_attention
from dmi_tpu_torch.utils import rng
from dmi_tpu_torch.utils.profiling import region, span

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The fields of dmi_tpu.models.llama.LlamaConfig, with a torch dtype
    (its attention_impl, a TPU switch, has no counterpart)."""

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
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    # Llama-3.x instruct EOS ids: <|end_of_text|>, <|eom_id|>, <|eot_id|>
    eos_token_ids: Tuple[int, ...] = (128001, 128008, 128009)
    bos_token_id: int = 128000
    attention_bias: bool = False                # q/k/v biases (qwen2); o stays bias-free
    mlp_act: str = "silu"                       # "gelu_tanh" for gemma
    attn_scale: Optional[float] = None          # score multiplier; None -> head_dim**-0.5
    attn_logit_softcap: Optional[float] = None  # cap * tanh(score / cap) (gemma-2: 50)
    final_logit_softcap: Optional[float] = None  # gemma-2: 30
    embedding_normalizer: Optional[float] = None  # gemma: sqrt(H); granite: its multiplier
    # gemma-2 scales the stream at model entry (caller embeddings included);
    # gemma-3 scales the embedding lookup instead
    embedding_scale_at_lookup: bool = False
    post_block_norms: bool = False              # gemma: post-attention / post-MLP norms
    norm_plus_one: bool = False                 # gemma (1 + w) norms, folded at import
    sliding_window: Optional[int] = None
    layer_sliding: Optional[Tuple[bool, ...]] = None  # per-layer sliding flags
    qk_norm: bool = False                       # qwen3, gemma-3: per-head q/k RMSNorm
    qk_norm_wide: bool = False                  # olmo2: RMSNorm over the whole q/k width
    # gemma-3 dual rope: sliding layers at this base, never scaled; full
    # layers at rope_theta, optionally linear-scaled
    rope_local_theta: Optional[float] = None
    rope_linear_factor: Optional[float] = None  # HF rope_scaling {"rope_type": "linear"}
    norm_after: bool = False                    # olmo2: no pre-norms; norm the block outputs
    residual_multiplier: Optional[float] = None  # granite: x + out * m
    logit_scale: Optional[float] = None         # granite: logits / logits_scaling

    # sparse MoE (mixtral, qwen3-moe, olmoe, deepseek-v2): > 0 replaces the
    # gated MLP with num_experts experts under a top-k softmax router,
    # evaluated densely (every expert runs; unselected weights are 0)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_norm_topk: bool = True                  # renormalise the kept top-k weights
    # deepseek-v2 multi-head latent attention: kv_lora_rank set => MLA.
    # head_dim is the q/k width (qk_nope + qk_rope), values are v_head_dim
    # wide; rope is interleaved over the qk_rope channel only
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None
    rope_interleaved: bool = False
    # yarn rope scaling (HF _compute_yarn_parameters); its attention factor
    # multiplies both cos and sin
    rope_yarn_factor: Optional[float] = None
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_yarn_mscale: Optional[float] = None
    rope_yarn_mscale_all_dim: Optional[float] = None
    rope_yarn_attention_factor: Optional[float] = None
    rope_yarn_truncate: bool = True
    # deepseek-v2 MoE: kept weights times routed_scaling_factor, always-on
    # shared experts (width n * intermediate), the gate product in f32
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0
    moe_gate_fp32: bool = False
    # deepseek-v3 routing ("sigmoid"): sigmoid scores, a per-expert
    # correction bias (router_bias) added for the choice only, the choice
    # limited to the moe_topk_group best of moe_n_group expert groups
    moe_scoring: str = "softmax"
    moe_n_group: int = 1
    moe_topk_group: int = 1
    # one expert-parallel rank's share: the layers hold the stacks of
    # experts [e0, e1) of the num_experts the router scores; None: all
    moe_expert_range: Optional[Tuple[int, int]] = None
    # per-layer MLP kind (deepseek's leading dense layers): True a routed
    # MLP, False a dense one dense_intermediate_size wide; None: every
    # layer routed iff num_experts
    moe_layers: Optional[Tuple[bool, ...]] = None
    dense_intermediate_size: Optional[int] = None


def moe_layer(cfg: LlamaConfig, i: int) -> bool:
    """Whether layer i holds a routed MLP (the tree then has w_router,
    which is what the forward passes test)."""
    return cfg.moe_layers[i] if cfg.moe_layers is not None else bool(cfg.num_experts)


def held_experts(cfg: LlamaConfig, shard=None) -> Optional[slice]:
    """The columns of the router's num_experts whose stacks a layer holds: a
    mesh rank's experts (Shard e0:e1) or the config's expert-parallel share
    (moe_expert_range); None where the stacks hold every expert."""
    if shard is not None:
        return slice(shard.e0, shard.e1)
    if cfg.moe_expert_range is not None:
        return slice(*cfg.moe_expert_range)
    return None


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


def tiny_qwen2_config(**kw) -> LlamaConfig:
    """Qwen2 family: q/k/v biases."""
    return dataclasses.replace(tiny_config(**kw), attention_bias=True)


def tiny_qwen3_config(**kw) -> LlamaConfig:
    """Qwen3 family: per-head q/k RMSNorm before rope, no biases."""
    return dataclasses.replace(tiny_config(**kw), qk_norm=True)


def tiny_olmo2_config(**kw) -> LlamaConfig:
    """Olmo2 family: RMSNorm over the whole q/k projections before rope, and
    post-norm blocks (no input norms; the two norms apply to the block
    outputs before the residual add)."""
    return dataclasses.replace(tiny_config(**kw), qk_norm_wide=True, norm_after=True)


def tiny_granite_config(**kw) -> LlamaConfig:
    """Granite family: llama math with the embedding, attention, residual
    and logits multipliers."""
    return dataclasses.replace(tiny_config(**kw), embedding_normalizer=12.0, attn_scale=0.03125,
                               residual_multiplier=0.22, logit_scale=16.0)


def tiny_gemma2_config(sliding_window=None, **kw) -> LlamaConfig:
    """Gemma-2 family: GeGLU, (1 + w) norms, post-block norms, attention and
    final softcaps, the sqrt(H) embedding normalizer, the query_pre_attn
    scale and, with a window, interleaved sliding layers from layer 0."""
    cfg = tiny_config(**kw)
    return dataclasses.replace(
        cfg, mlp_act="gelu_tanh", attn_scale=float(cfg.head_dim) ** -0.5,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        embedding_normalizer=float(cfg.hidden_size) ** 0.5, post_block_norms=True,
        norm_plus_one=True, sliding_window=sliding_window,
        layer_sliding=(tuple(i % 2 == 0 for i in range(cfg.num_hidden_layers))
                       if sliding_window else None),
    )


def tiny_gemma3_config(sliding_window=8, **kw) -> LlamaConfig:
    """Gemma-3 text family: gemma-2's without the softcaps, plus per-head
    q/k norms, the embedding scale at lookup and dual rope (sliding layers
    at the local theta, unscaled; full layers linear-scaled); layers
    alternate so that two layers take both rope tables."""
    cfg = tiny_config(**kw)
    return dataclasses.replace(
        cfg, mlp_act="gelu_tanh", attn_scale=float(cfg.head_dim) ** -0.5,
        embedding_normalizer=float(cfg.hidden_size) ** 0.5, embedding_scale_at_lookup=True,
        post_block_norms=True, norm_plus_one=True, qk_norm=True, rope_theta=1_000_000.0,
        rope_local_theta=10_000.0, rope_linear_factor=8.0, sliding_window=sliding_window,
        layer_sliding=tuple(i % 2 == 0 for i in range(cfg.num_hidden_layers)),
    )


def tiny_mixtral_config(n_experts=4, top_k=2, **kw) -> LlamaConfig:
    """Mixtral family: llama attention and the sparse-MoE MLP (top-k softmax
    router over gated-silu experts, the kept weights renormalised)."""
    return dataclasses.replace(tiny_config(**kw), num_experts=n_experts, num_experts_per_tok=top_k)


def tiny_qwen3moe_config(n_experts=4, top_k=2, **kw) -> LlamaConfig:
    """Qwen3-MoE family: qwen3's per-head q/k norms and the sparse-MoE MLP
    without the top-k renormalisation (norm_topk_prob false)."""
    return dataclasses.replace(tiny_config(**kw), qk_norm=True, num_experts=n_experts,
                               num_experts_per_tok=top_k, moe_norm_topk=False)


def tiny_olmoe_config(n_experts=4, top_k=2, **kw) -> LlamaConfig:
    """OLMoE family: olmo2's whole-width q/k norms in pre-norm blocks, and
    the sparse-MoE MLP without the top-k renormalisation."""
    return dataclasses.replace(tiny_config(**kw), qk_norm_wide=True, num_experts=n_experts,
                               num_experts_per_tok=top_k, moe_norm_topk=False)


def tiny_deepseek_config(q_lora_rank=None, n_experts=0, top_k=2, n_shared=0,
                         routed_scale=1.0, **kw) -> LlamaConfig:
    """DeepSeek-V2 family: MLA (latent rank 16, q/k 8 + 4 rope dims, values
    8 wide, interleaved rope), optionally a q_lora_rank bottleneck (None:
    the Lite layout's plain q projection) and the deepseek MoE (greedy
    top-k over an f32 gate, routed_scaling_factor, n_shared shared
    experts).  head_dim is the q/k width, 12."""
    cfg = tiny_config(**kw)
    return dataclasses.replace(
        cfg, num_key_value_heads=cfg.num_attention_heads, head_dim=12, q_lora_rank=q_lora_rank,
        kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
        rope_interleaved=True, num_experts=n_experts, num_experts_per_tok=top_k,
        moe_norm_topk=False, moe_gate_fp32=bool(n_experts),
        routed_scaling_factor=routed_scale, n_shared_experts=n_shared,
    )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init(cfg: LlamaConfig, generator: rng.Generator, device="cpu") -> dict:
    """Random init: weights normal(0, 0.02) drawn in f32 from `generator`
    (a torch.Generator on `device`, or a CounterRNG) and cast to cfg.dtype;
    norms are ones.
    The family leaves as dmi_tpu's init names and shapes them: biases
    bq/bk/bv, q_norm/k_norm ([hd], or the whole width with qk_norm_wide),
    ln_post_attn/ln_post_mlp, an untied lm_head [H, V]; with experts
    w_router [H, E] and the stacks moe_w1/moe_w3 [E, H, I], moe_w2
    [E, I, H] (and w_shared_{gate,up,down} of width n_shared * I); with MLA
    wkv_a [H, r + dr], kv_a_norm [r], wkv_b [r, nh (dn + dv)], wo
    [nh dv, H] and either wq [H, nh (dn + dr)] or wq_a, q_a_norm, wq_b.
    Each layer takes the MLP moe_layer names: a routed one's stacks hold
    the experts held_experts names (its router scores all num_experts; a
    sigmoid router has its correction bias router_bias [E]), a dense one
    is dense_intermediate_size wide in a mixed stack."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def w(*shape):
        return (rng.normal(generator, shape, device) * 0.02).to(cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    layers = []
    for i in range(cfg.num_hidden_layers):
        if cfg.kv_lora_rank is not None:
            r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            dv = cfg.v_head_dim
            lw = {"wkv_a": w(H, r + dr), "kv_a_norm": ones(r), "wkv_b": w(r, nh * (dn + dv)),
                  "wo": w(nh * dv, H)}
            if cfg.q_lora_rank is None:
                lw["wq"] = w(H, nh * (dn + dr))
            else:
                lw.update(wq_a=w(H, cfg.q_lora_rank), q_a_norm=ones(cfg.q_lora_rank),
                          wq_b=w(cfg.q_lora_rank, nh * (dn + dr)))
        else:
            lw = {"wq": w(H, nh * hd), "wk": w(H, nkv * hd), "wv": w(H, nkv * hd),
                  "wo": w(nh * hd, H)}
        if moe_layer(cfg, i):
            E = cfg.num_experts
            held = held_experts(cfg)
            Eh = E if held is None else held.stop - held.start
            lw.update(w_router=w(H, E), moe_w1=w(Eh, H, I), moe_w3=w(Eh, H, I),
                      moe_w2=w(Eh, I, H))
            if cfg.moe_scoring == "sigmoid":
                lw["router_bias"] = w(E)
            if cfg.n_shared_experts:
                Is = I * cfg.n_shared_experts
                lw.update(w_shared_gate=w(H, Is), w_shared_up=w(H, Is), w_shared_down=w(Is, H))
        else:
            Id = cfg.dense_intermediate_size or I
            lw.update(w_gate=w(H, Id), w_up=w(H, Id), w_down=w(Id, H))
        lw.update(ln_attn=ones(H), ln_mlp=ones(H))
        if cfg.attention_bias:
            lw.update(bq=w(nh * hd), bk=w(nkv * hd), bv=w(nkv * hd))
        if cfg.post_block_norms:
            lw.update(ln_post_attn=ones(H), ln_post_mlp=ones(H))
        if cfg.qk_norm:
            lw.update(q_norm=ones(hd), k_norm=ones(hd))
        if cfg.qk_norm_wide:
            lw.update(q_norm=ones(nh * hd), k_norm=ones(nkv * hd))
        layers.append(lw)
    params = {"embed": w(cfg.vocab_size, H), "layers": layers, "final_norm": ones(H)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(H, cfg.vocab_size)
    return params


def fuse_projections(params: dict) -> dict:
    """Concatenate wq|wk|wv -> w_qkv, bq|bk|bv -> b_qkv and w_gate|w_up ->
    w_gu in every layer (fewer, wider matmuls per decode step); MLA layers
    (no wk) keep their projections.  MoE layers replace the gate and up
    stacks moe_w1/moe_w3 [E, H, I] by moe_w1t/moe_w3t [E, I, H] (each
    expert's Linear weight as HF stores it), so that `.view(E * I, H)` is
    the 2-D operand of the routed MLP's products (_moe_mlp); moe_w2
    [E, I, H] already views as [E * I, H].  The originals are popped, as
    wq/wk/wv are, and the caller's tensors left as they are; quantized
    stacks keep their layout.  Idempotent."""
    layers = []
    for lw in params["layers"]:
        lw = dict(lw)
        if "wk" in lw:
            lw["w_qkv"] = torch.cat([lw.pop("wq"), lw.pop("wk"), lw.pop("wv")], dim=-1)
        if "w_gate" in lw:
            lw["w_gu"] = torch.cat([lw.pop("w_gate"), lw.pop("w_up")], dim=-1)
        if "bq" in lw:
            lw["b_qkv"] = torch.cat([lw.pop("bq"), lw.pop("bk"), lw.pop("bv")], dim=-1)
        for key in ("moe_w1", "moe_w3"):
            if isinstance(lw.get(key), torch.Tensor):
                lw[key + "t"] = lw.pop(key).transpose(1, 2).contiguous()
        layers.append(lw)
    return {**params, "layers": layers}


def expert_stacks(lw: dict, dtype) -> tuple:
    """An MoE layer's gate, up and down stacks, each [E, I, H]: the
    prepared moe_w1t/moe_w3t of fuse_projections, dequantized along their
    contraction axis H (quant.EXPERT_ROWS); an unfused tree's moe_w1/moe_w3
    [E, H, I] dequantized and transposed (a view, which the products'
    reshape then copies on every call)."""
    def rows(key):
        if key + "t" in lw:
            return dequantize(lw[key + "t"], dtype, axis=-1)
        return dequantize(lw[key], dtype).transpose(1, 2)

    return rows("moe_w1"), rows("moe_w3"), dequantize(lw["moe_w2"], dtype)


def hf_layer_keys(cfg: LlamaConfig, fused: bool, moe: str = "mlp",
                  sparse: Optional[bool] = None) -> dict:
    """The port's per-layer names -> (HF key under model.layers.{i}., kind):
    "w" a Linear weight, transposed from HF's (out, in) to (in, out); "b" a
    bias; "f" a vector kept in f32 (deepseek-v3's e_score_correction_bias,
    which HF keeps in f32 too); "n" a norm ((1 + w) folded when
    cfg.norm_plus_one); "x" an expert stack, the key holding "{e}" for the
    expert index, each expert a Linear weight.  `fused`: phi-3's checkpoint
    layout, one qkv_proj and one gate_up_proj, split at import.  `moe`: the
    module of the experts, "mlp" (qwen3-moe, olmoe, deepseek: gate_proj/
    up_proj/down_proj) or "block_sparse_moe" (mixtral: w1/w3/w2).  `sparse`:
    whether this layer holds the routed MLP (moe_layer; None: every layer
    routed iff cfg.num_experts), else the dense gate/up/down.  MLA layers
    have deepseek's kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj and a
    q_proj or the q_a_proj, q_a_layernorm, q_b_proj bottleneck.  The norms'
    roles follow dmi_tpu's from_hf_state_dict: gemma's pre-MLP norm is
    pre_feedforward_layernorm, and olmo2 (norm_after) has no pre-norms, its
    ln_attn/ln_mlp being the post-attention and post-feedforward norms of
    the block outputs."""
    if cfg.kv_lora_rank is not None:
        keys = {"wkv_a": ("self_attn.kv_a_proj_with_mqa.weight", "w"),
                "kv_a_norm": ("self_attn.kv_a_layernorm.weight", "n"),
                "wkv_b": ("self_attn.kv_b_proj.weight", "w")}
        if cfg.q_lora_rank is None:
            keys["wq"] = ("self_attn.q_proj.weight", "w")
        else:
            keys.update(wq_a=("self_attn.q_a_proj.weight", "w"),
                        q_a_norm=("self_attn.q_a_layernorm.weight", "n"),
                        wq_b=("self_attn.q_b_proj.weight", "w"))
    elif fused:
        keys = {"w_qkv": ("self_attn.qkv_proj.weight", "w")}
    else:
        keys = {"wq": ("self_attn.q_proj.weight", "w"), "wk": ("self_attn.k_proj.weight", "w"),
                "wv": ("self_attn.v_proj.weight", "w")}
    keys["wo"] = ("self_attn.o_proj.weight", "w")
    if sparse is None:
        sparse = bool(cfg.num_experts)
    if sparse:
        names = ("w1", "w3", "w2") if moe == "block_sparse_moe" else \
            ("gate_proj", "up_proj", "down_proj")
        keys["w_router"] = (f"{moe}.gate.weight", "w")
        if cfg.moe_scoring == "sigmoid":
            keys["router_bias"] = (f"{moe}.gate.e_score_correction_bias", "f")
        for name, hf in zip(("moe_w1", "moe_w3", "moe_w2"), names):
            keys[name] = (f"{moe}.experts.{{e}}.{hf}.weight", "x")
        if cfg.n_shared_experts:
            keys.update(w_shared_gate=(f"{moe}.shared_experts.gate_proj.weight", "w"),
                        w_shared_up=(f"{moe}.shared_experts.up_proj.weight", "w"),
                        w_shared_down=(f"{moe}.shared_experts.down_proj.weight", "w"))
    elif fused:
        keys["w_gu"] = ("mlp.gate_up_proj.weight", "w")
    else:
        keys.update(w_gate=("mlp.gate_proj.weight", "w"), w_up=("mlp.up_proj.weight", "w"))
    if not sparse:
        keys["w_down"] = ("mlp.down_proj.weight", "w")
    if cfg.norm_after:
        keys.update(ln_attn=("post_attention_layernorm.weight", "n"),
                    ln_mlp=("post_feedforward_layernorm.weight", "n"))
    elif cfg.post_block_norms:
        keys.update(ln_attn=("input_layernorm.weight", "n"),
                    ln_mlp=("pre_feedforward_layernorm.weight", "n"),
                    ln_post_attn=("post_attention_layernorm.weight", "n"),
                    ln_post_mlp=("post_feedforward_layernorm.weight", "n"))
    else:
        keys.update(ln_attn=("input_layernorm.weight", "n"),
                    ln_mlp=("post_attention_layernorm.weight", "n"))
    if cfg.attention_bias:
        keys.update(bq=("self_attn.q_proj.bias", "b"), bk=("self_attn.k_proj.bias", "b"),
                    bv=("self_attn.v_proj.bias", "b"))
    if cfg.qk_norm or cfg.qk_norm_wide:
        keys.update(q_norm=("self_attn.q_norm.weight", "n"),
                    k_norm=("self_attn.k_norm.weight", "n"))
    return keys


def from_hf_state_dict(state_dict, cfg: LlamaConfig, device="cpu") -> dict:
    """An HF *ForCausalLM state dict of one of the families -> the
    parameters `init` makes, on `device` (dmi_tpu's from_hf_state_dict,
    per-layer lists in place of [L, ...] stacks).  Weights and biases go to
    cfg.dtype, and a tensor already in cfg.dtype keeps its bits; with
    cfg.norm_plus_one (gemma) every norm is stored as f32(w) + 1 in f32, so
    the fold is exact; phi-3's fused qkv_proj / gate_up_proj are split; each
    layer's experts are stacked [E, in, out].  A key the config's layout
    does not use (biases, norms, experts or projections the config has not)
    is refused; so is an lm_head.weight under a tied config unless it is the
    embedding itself (the tied head saved twice, as .bin files do).  Each
    layer takes its own MLP's keys (moe_layer: deepseek's leading dense
    layers), and a share of the experts (moe_expert_range) reads the
    experts it holds, in index order."""
    keys = set(state_dict)
    fused = "model.layers.0.self_attn.qkv_proj.weight" in keys
    moe = ("block_sparse_moe" if "model.layers.0.block_sparse_moe.gate.weight" in keys
           else "mlp")
    held = held_experts(cfg) or slice(0, cfg.num_experts)
    per_layer = {}
    for i in range(cfg.num_hidden_layers):
        for name, (hf, kind) in hf_layer_keys(cfg, fused, moe, moe_layer(cfg, i)).items():
            if kind == "x":
                for e in range(held.start, held.stop):
                    per_layer[f"model.layers.{i}.{hf.format(e=e)}"] = (i, name, kind)
            else:
                per_layer[f"model.layers.{i}.{hf}"] = (i, name, kind)
    top = {"model.embed_tokens.weight", "model.norm.weight"}
    if not cfg.tie_word_embeddings:
        top.add("lm_head.weight")
    missing = sorted((top | set(per_layer)) - keys)
    if missing:
        raise KeyError(f"the HF state dict lacks {missing[:8]} ({len(missing)} keys)")
    extra = sorted(keys - top - set(per_layer) - {"lm_head.weight"})
    head = state_dict.get("lm_head.weight")
    if (cfg.tie_word_embeddings and head is not None
            and not torch.equal(head, state_dict["model.embed_tokens.weight"])):
        extra.append("lm_head.weight (differs from the tied embedding)")
    if extra:
        raise ValueError(
            f"HF keys this config's layout does not use: {extra[:8]} ({len(extra)} keys)")

    def get(key, kind="w"):
        t = state_dict[key]
        if kind == "n" and cfg.norm_plus_one:
            return (t.float() + 1.0).to(device)
        if kind == "f":
            return t.to(device=device, dtype=torch.float32)
        t = t.to(device=device, dtype=cfg.dtype)
        return (t.t() if kind in ("w", "x") else t).contiguous()

    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = [{} for _ in range(cfg.num_hidden_layers)]
    experts = [{} for _ in range(cfg.num_hidden_layers)]
    for key, (i, name, kind) in per_layer.items():  # experts in index order
        if kind == "x":
            experts[i].setdefault(name, []).append(get(key, kind))
        else:
            layers[i][name] = get(key, kind)
    for lw, stacks in zip(layers, experts):
        for name in list(stacks):
            lw[name] = torch.stack(stacks.pop(name))
    if fused:
        for lw in layers:
            q, k, v = lw.pop("w_qkv").split([nh * hd, nkv * hd, nkv * hd], dim=-1)
            gate, up = lw.pop("w_gu").chunk(2, dim=-1)
            lw.update(wq=q.contiguous(), wk=k.contiguous(), wv=v.contiguous(),
                      w_gate=gate.contiguous(), w_up=up.contiguous())
    params = {"embed": get("model.embed_tokens.weight", "e"), "layers": layers,
              "final_norm": get("model.norm.weight", "n")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight")
    return params


# ---------------------------------------------------------------------------
# Rope
# ---------------------------------------------------------------------------

def rope_inv_freq(cfg: LlamaConfig, device="cpu", local: bool = False) -> torch.Tensor:
    """Base inverse frequencies over rope_dim(cfg), f32: with yarn scaling
    (HF _compute_yarn_parameters: the interpolated and extrapolated
    frequencies blended over a linear ramp between the beta_fast and
    beta_slow correction dims), Llama-3 wavelength-dependent scaling (HF
    _compute_llama3_parameters) or HF "linear" scaling (inv_freq / factor).
    local=True is gemma-3's sliding-layer table: plain rope at
    rope_local_theta, never scaled."""
    hd = rope_dim(cfg)
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    if local:
        return 1.0 / (cfg.rope_local_theta ** exponent)
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    if cfg.rope_yarn_factor is not None:
        def corr_dim(n_rot):
            return (hd * math.log(cfg.rope_original_max_position / (n_rot * 2 * math.pi))
                    / (2 * math.log(cfg.rope_theta)))

        low, high = corr_dim(cfg.rope_yarn_beta_fast), corr_dim(cfg.rope_yarn_beta_slow)
        if cfg.rope_yarn_truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, hd - 1)
        if low == high:
            high += 0.001  # HF's guard against a zero-width ramp
        ramp = ((torch.arange(hd // 2, dtype=torch.float32, device=device) - low)
                / (high - low)).clamp(0, 1)
        extrapolation = 1.0 - ramp
        return (inv_freq / cfg.rope_yarn_factor) * (1 - extrapolation) + inv_freq * extrapolation
    if cfg.rope_linear_factor is not None:
        return inv_freq / cfg.rope_linear_factor
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


def rope_dim(cfg: LlamaConfig) -> int:
    """The width the rope tables cover: head_dim, except MLA, where only the
    decoupled qk_rope_head_dim channel ropes."""
    return cfg.qk_rope_head_dim if cfg.kv_lora_rank is not None else cfg.head_dim


def rope_attention_factor(cfg: LlamaConfig) -> float:
    """Yarn's post-scaling of the cos/sin tables (HF attention_factor; with
    deepseek's mscale and mscale_all_dim the ratio of the two corrections,
    under the same truthiness test as transformers'); 1.0 for every other
    table.  HF multiplies the complex phasor, so both cos and sin carry
    it, as in dmi_tpu."""
    if cfg.rope_yarn_factor is None:
        return 1.0
    if cfg.rope_yarn_attention_factor is not None:
        return float(cfg.rope_yarn_attention_factor)

    def get_mscale(scale, mscale=1.0):
        return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0

    f = cfg.rope_yarn_factor
    if cfg.rope_yarn_mscale and cfg.rope_yarn_mscale_all_dim:
        return float(get_mscale(f, cfg.rope_yarn_mscale)
                     / get_mscale(f, cfg.rope_yarn_mscale_all_dim))
    return float(get_mscale(f))


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor,
                local: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*, rope_dim] in f32 (HF duplicates freqs: cat(f, f)),
    times yarn's attention factor; local=True the gemma-3 sliding layers'
    tables."""
    inv = rope_inv_freq(cfg, positions.device, local)
    freqs = positions[..., None].to(torch.float32) * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = rope_attention_factor(cfg)
    if scale == 1.0:
        return torch.cos(emb), torch.sin(emb)
    return torch.cos(emb) * scale, torch.sin(emb) * scale


def rope_dual(cfg: LlamaConfig) -> bool:
    """True when the layers choose between two rope tables (gemma-3): the
    sliding layers take the local one, at every sequence length."""
    if cfg.rope_local_theta is None:
        return False
    if cfg.layer_sliding is None:
        raise ValueError("rope_local_theta requires layer_sliding flags (the sliding layers "
                         "are the local-rope layers)")
    return True


def sliding_effective(cfg: LlamaConfig, max_positions: int) -> bool:
    """True when a sliding layer's window can mask a key the causal mask
    keeps: a sliding layer exists and some query looks back at least
    sliding_window positions among max_positions."""
    return (cfg.sliding_window is not None and cfg.layer_sliding is not None
            and any(cfg.layer_sliding) and max_positions > cfg.sliding_window)


def window_mask(cfg: LlamaConfig, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """HF's sliding-window overlay: a key is inside a query's window iff
    q_pos - k_pos < sliding_window (the last `window` positions, the
    query's own included); broadcasting, so [T, 1] x [S] gives [T, S]."""
    return (q_pos - k_pos) < cfg.sliding_window


def layer_inputs(cfg: LlamaConfig, layer: int, bias, bias_sw, rope, rope_local):
    """The bias and the (cos, sin) tables of one layer: a layer flagged
    sliding in cfg.layer_sliding takes the window bias (when one is given:
    None while no window binds) and, with dual rope, the local tables."""
    sliding = cfg.layer_sliding is not None and cfg.layer_sliding[layer]
    return (bias_sw if sliding and bias_sw is not None else bias,
            rope_local if sliding and rope_local is not None else rope)


def flash_route(cfg: LlamaConfig, T: int) -> bool:
    """Whether the full-sequence forward runs the flash attention kernels
    (dmi_tpu's use_flash, llama.py:1311-1322): no attention softcap, no
    sliding window that binds within T positions, no dual rope and no MLA
    (its q/k and v widths differ); the rest runs `_attention` with the
    additive bias.  Chosen by the config, never
    by a failure."""
    return (cfg.attn_logit_softcap is None and not sliding_effective(cfg, T)
            and cfg.rope_local_theta is None and cfg.kv_lora_rank is None)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, n, T, hd]; cos/sin: [T, hd]; computed in f32."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Deepseek's rope: adjacent pairs (x0, x1), (x2, x3), ... rotate as
    complex numbers (HF apply_rotary_emb), where rotate_half pairs the front
    and back halves.  x [B, n, T, d]; cos/sin the duplicated [T, d] tables,
    pair j reading entry j; computed in f32."""
    d2 = x.shape[-1] // 2
    c, s = cos[..., :d2], sin[..., :d2]
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([even * c - odd * s, odd * c + even * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def in_dtype(c: float, dtype: torch.dtype) -> float:
    """The Python scalar c rounded to `dtype`.  JAX rounds a weak-typed
    scalar to the array's dtype before an elementwise op; torch keeps the
    scalar in its f32 op math, so the port rounds it first and both form
    the same product."""
    return float(torch.tensor(c, dtype=dtype))


def scale_embeds(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma-2's sqrt(H) embedding normalizer (granite's embedding
    multiplier), rounded to the model dtype, on the stream at model entry,
    caller embeddings included (HF Gemma2Model); identity for the other
    families and for gemma-3, whose embed_tokens carries the scale."""
    if cfg.embedding_normalizer is None or cfg.embedding_scale_at_lookup:
        return x
    return x * in_dtype(cfg.embedding_normalizer, x.dtype)


def final_softcap(cfg: LlamaConfig, logits: torch.Tensor) -> torch.Tensor:
    """The head's output transforms in the logits dtype: granite's divide by
    logits_scaling, then gemma-2's tanh cap (HF semantics).  Both are
    monotone, so greedy argmax paths may skip them; the loss and the sampler
    take the logits through here."""
    if cfg.logit_scale is not None:
        logits = logits / in_dtype(cfg.logit_scale, logits.dtype)
    if cfg.final_logit_softcap is None:
        return logits
    cap = in_dtype(cfg.final_logit_softcap, logits.dtype)
    return torch.tanh(logits / cap) * cap


def embed_tokens(cfg: LlamaConfig, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows; a quantized embed ({"q"|"q8", "s" [V, 1]}) gathers
    int8 rows and rescales them by their row scales in cfg.dtype.  gemma-3
    scales the rows here (Gemma3TextScaledWordEmbedding).  A sharded tree
    looks up its vocab rows and sums the model ranks' (Shard.embed)."""
    embed = params["embed"]

    def lookup(ids):
        if isinstance(embed, dict):
            qk = "q8" if "q8" in embed else "q"
            return embed[qk][ids].to(cfg.dtype) * embed["s"][ids].to(cfg.dtype)
        return embed[ids]

    shard = params.get("shard")
    rows = lookup(input_ids) if shard is None else shard.embed(input_ids, lookup)
    if cfg.embedding_normalizer is not None and cfg.embedding_scale_at_lookup:
        rows = rows * in_dtype(cfg.embedding_normalizer, rows.dtype)
    return rows


def _mm(h: torch.Tensor, w, shard=None) -> torch.Tensor:
    """h [..., in] @ w [in, out], dispatching on the quantized weight dicts
    of models/quant.py (dmi_tpu's llama._mm): h @ (q * s) == (h @ q) * s
    with per-output-column scales.  "q8" and "qp" weights quantize the
    activations per token and take the exact integer product
    (quant.int_matmul), rescaled by both factors in dmi_tpu's order.  This
    is the prefill's form; the decode loop's is decode._mm_bl.

    shard: w is row-parallel, its rows this rank's slice of the contraction
    (wo, w_down): the partial products, in f32 (integers for "q8" and
    "qp"), are summed over the model group before the scales apply and the
    one rounding to h's dtype, and the activations are quantized with the
    amax over all of the contraction (the one-rank scales)."""
    if shard is None:
        def red(t):
            return t
    else:
        def red(t):
            return shard.psum(t.float())
    if not isinstance(w, dict):
        return h @ w if shard is None else red(h.float() @ w.float()).to(h.dtype)
    if "q8" in w or "qp" in w:
        hq, a = quantize_act(h, axis=-1, reduce=None if shard is None else shard.pmax)
    if "q8" in w:
        return (red(int_matmul(hq, w["q8"])) * a * w["s"]).to(h.dtype)
    if "qp" in w:
        q8 = unpack_w4(w["qp"])
        if "s4g" in w:
            # grouped scales: G partial products, each weighted by its
            # group's scales, then summed
            s4g = w["s4g"]
            G, K = s4g.shape[-2], q8.shape[-2]
            hg = hq.reshape(*hq.shape[:-1], G, 1, K // G)
            qg = q8.reshape(G, K // G, q8.shape[-1])
            acc = int_matmul(hg, qg).squeeze(-2)  # [..., G, out]
            return (red((acc * s4g).sum(dim=-2)) * a).to(h.dtype)
        return (red(int_matmul(hq, q8)) * a * w["s"]).to(h.dtype)
    if "q" in w:
        if shard is not None:
            return red(h.float() @ w["q"].float()).to(h.dtype) * w["s"].to(h.dtype)
        return (h @ w["q"].to(h.dtype)) * w["s"].to(h.dtype)
    raise ValueError(f"unknown quantized dict keys {sorted(w)}")


def _head_matmul(x: torch.Tensor, params: dict, cfg: LlamaConfig) -> torch.Tensor:
    """Tied head: logits = x @ embed.T (a transposed view, no copy); a
    quantized embed's per-row scales are the head's output-channel scales.
    Untied: x @ lm_head through _mm.  A sharded tree's vocab-sharded
    logits are gathered over the model group, in global vocab order."""
    shard = params.get("shard")
    logits = _head_matmul_local(x, params, cfg)
    return logits if shard is None else shard.gather_vocab(logits, -1)


def _head_matmul_local(x: torch.Tensor, params: dict, cfg: LlamaConfig) -> torch.Tensor:
    if not cfg.tie_word_embeddings:
        return _mm(x, params["lm_head"])
    embed = params["embed"]
    if isinstance(embed, dict) and "q8" in embed:
        hq, a = quantize_act(x, axis=-1)
        return (int_matmul(hq, embed["q8"].t()) * a * embed["s"][:, 0]).to(x.dtype)
    if isinstance(embed, dict):
        return (x @ embed["q"].to(x.dtype).t()) * embed["s"].to(x.dtype)[:, 0]
    return x @ embed.t()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, shard=None) -> torch.Tensor:
    """RMSNorm over the last axis in f32.  shard: x holds this rank's
    columns of a norm over the whole width (olmo2's q/k norms; scale is the
    matching slice): the sum of squares is summed over the model group and
    divided by x's width times m, which is the whole width's mean also
    where the ranks hold copies of one kv head (each copy counted m/nkv
    times over a width m/nkv times too small).  Each rank's columns consume
    the shared sum, so its backward sums the ranks' gradients too
    (Shard.psum_shared)."""
    xf = x.float()
    if shard is None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = shard.psum_shared((xf * xf).sum(dim=-1, keepdim=True)) / (x.shape[-1] * shard.m)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mlp_activation(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """silu (llama, mistral, qwen, phi-3, olmo2, granite) or tanh-approximated
    GELU (gemma)."""
    if cfg.mlp_act == "silu":
        return F.silu(x)
    if cfg.mlp_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")


def moe_gate_weights(cfg: LlamaConfig, router_logits: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token expert weights [..., E] from router logits [..., E]
    (dmi_tpu's moe_gate_weights, HF's sparse-MoE gates): softmax over the
    experts in f32, keep the top num_experts_per_tok, renormalise the kept
    ones when cfg.moe_norm_topk, times routed_scaling_factor (deepseek);
    0 for every other expert.  Among equal probabilities the lower expert
    index is kept, as jax.lax.top_k keeps it (torch.topk promises no order
    for ties): a stable descending sort.

    moe_scoring "sigmoid" (deepseek-v3's noaux_tc, transformers'
    DeepseekV3TopkRouter), in f32: s = sigmoid(logits), c = s + bias (the
    correction bias [E], router_bias); a group of E / moe_n_group experts
    scores the sum of its top 2 c, the moe_topk_group best groups are kept
    and the other groups' c set to 0; the top k of c are chosen (ties to
    the lower index, groups and experts alike) and weighted by s, without
    the bias, over their sum (+ 1e-20) when moe_norm_topk, times
    routed_scaling_factor."""
    k = cfg.num_experts_per_tok
    if cfg.moe_scoring == "softmax":
        probs = torch.softmax(router_logits.float(), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        if cfg.moe_norm_topk:
            vals = vals / vals.sum(dim=-1, keepdim=True)
    elif cfg.moe_scoring == "sigmoid":
        probs = torch.sigmoid(router_logits.float())
        choice = probs + bias.float()
        G = cfg.moe_n_group
        if G > 1:
            groups = choice.unflatten(-1, (G, -1))
            score = groups.topk(2, dim=-1).values.sum(dim=-1)  # [..., G]
            keep = torch.sort(score, dim=-1, descending=True, stable=True).indices
            mask = torch.zeros_like(score, dtype=torch.bool).scatter(
                -1, keep[..., :cfg.moe_topk_group], True)
            choice = groups.masked_fill(~mask[..., None], 0.0).flatten(-2)
        idx = torch.sort(choice, dim=-1, descending=True, stable=True).indices[..., :k]
        vals = probs.gather(-1, idx)
        if cfg.moe_norm_topk:
            vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        raise ValueError(f"unknown moe_scoring {cfg.moe_scoring!r}")
    if cfg.routed_scaling_factor != 1.0:
        vals = vals * cfg.routed_scaling_factor
    return torch.zeros_like(probs).scatter(-1, idx, vals)


def _moe_mlp(cfg: LlamaConfig, lw: dict, h: torch.Tensor, shard=None) -> torch.Tensor:
    """The sparse-MoE MLP over h [B, T, H], dense-evaluated (dmi_tpu's
    _moe_mlp): every expert's gated MLP runs on every token, combined with
    moe_gate_weights (0 for the experts not chosen), so the result equals
    HF's sparse dispatch.  The router product runs in the model dtype, or
    in f32 with moe_gate_fp32 (deepseek); deepseek's shared experts add an
    always-on gated MLP.  The experts are three 2-D products over the N
    tokens x [N, H] and the stacks viewed [E * I, H] (expert_stacks):

        g, u = x @ W1^T, x @ W3^T                      [N, E * I]
        z    = act(g) * u * w_e, per expert's I columns
        out  = z @ W2                                  [N, H]

    the gate weights applied before the down product, so that product sums
    over the experts: no [E, N, H] tensor, and on a fused tree no copy
    forward or backward.  The stacks hold the experts held_experts names
    (all, a mesh rank's or an expert-parallel share's), the router scores
    all num_experts, and the layer adds its own experts' part.  shard: the
    layer holds this rank's experts [e0, e1) and its slice of the shared
    experts; the router is whole, and the partial combine is summed over
    the model group.  The experts read h and their gate weights through
    Shard.copy (the router's gradient sums the model ranks'); the router
    reads h as it is.  A config's share (moe_expert_range) is one chip's
    part of an expert-parallel layer run without its exchange: its partial
    result goes on as it is.  Span llama.moe (its backward llama.moe.bwd),
    the router product and gate weights inside it moe.route."""
    with region("llama.moe") as r:
        h = r.enter(h)
        B, T, H = h.shape
        with span("moe.route"):
            if cfg.moe_gate_fp32:
                router = h.float() @ dequantize(lw["w_router"], torch.float32).float()
            else:
                router = _mm(h, lw["w_router"])  # [B, T, E]
            w_e = moe_gate_weights(cfg, router, lw.get("router_bias")).to(h.dtype)
        w_e = w_e.reshape(B * T, -1)
        held = held_experts(cfg, shard)
        if shard is not None:
            w_e = shard.copy(w_e)
            h = shard.copy(h)
        if held is not None:
            w_e = w_e[:, held]
        w1, w3, w2 = expert_stacks(lw, h.dtype)
        E, I = w2.shape[:2]
        N = B * T
        x = h.reshape(N, H)
        g = x @ w1.reshape(E * I, H).t()  # [N, E * I]
        u = x @ w3.reshape(E * I, H).t()
        z = (mlp_activation(cfg, g) * u).view(N, E, I) * w_e[:, :, None]
        out = (z.view(N, E * I) @ w2.reshape(E * I, H)).view(B, T, H)
        if shard is not None:
            out = shard.psum(out.float()).to(h.dtype)
        if cfg.n_shared_experts:
            gate = mlp_activation(cfg, _mm(h, lw["w_shared_gate"]))
            out = out + _mm(gate * _mm(h, lw["w_shared_up"]), lw["w_shared_down"], shard)
        return r.leave(out)


def attn_score_scale(cfg: LlamaConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else float(cfg.head_dim) ** -0.5


def _attention(q, k, v, bias, scale=None, softcap=None):
    """q: [B,nh,T,hd], k/v: [B,nkv,S,hd] (MLA: v [B,nh,S,dv]), bias [T, S]
    or [B, T, S] f32 -> [B,nh,T,dv]; products in the input dtype, f32
    softmax (dmi_tpu's _attention)."""
    B, nh, T, hd = q.shape
    nkv = k.shape[1]
    q = q.reshape(B, nkv, nh // nkv, T, hd)
    scores = torch.einsum("bkgtd,bksd->bkgts", q, k).float()
    scores = scores * (scale if scale is not None else 1.0 / math.sqrt(hd))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    b = bias[:, None, None] if bias.ndim == 3 else bias
    probs = torch.softmax(scores + b, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, v)
    return out.reshape(B, nh, T, v.shape[-1])  # MLA: values are v_head_dim wide


def _write_cache(cache_kv, cache_index: int, k, v):
    """Write k/v [B, nkv, T, hd] into the caches at cache_index, in place;
    return views of the caches' written positions."""
    k_cache, v_cache = cache_kv
    end = cache_index + k.shape[2]
    k_cache[:, :, cache_index:end] = k
    v_cache[:, :, cache_index:end] = v
    return k_cache[:, :, :end], v_cache[:, :, :end]


def _mla_qkv(cfg: LlamaConfig, lw, h, cos, sin, shard=None):
    """MLA's q, k, v over h [B, T, H] (HF DeepseekV2Attention, dmi_tpu's
    expanded oracle): q per head [qk_nope | qk_rope], through the q_lora
    bottleneck where the layer has one; k and v expanded from one normed
    latent through wkv_b to per head [qk_nope | v_head_dim], with one
    shared roped key channel (MQA on the positional dims).  Returns q, k
    [B, nh, T, dn + dr], v [B, nh, T, dv] and the compressed rows
    [B, T, r + dr] (normed latent | roped shared key) that the batch-last
    loop caches.  shard: the layer holds this rank's heads; the replicated
    latents (and h before a plain wq) enter them through Shard.copy."""
    copy = (lambda t: t) if shard is None else shard.copy
    B, T, _ = h.shape
    nh, eps = cfg.num_attention_heads, cfg.rms_norm_eps
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv = cfg.v_head_dim
    if "wq" in lw:  # the Lite layout: a plain q projection
        q = _mm(copy(h), lw["wq"])
    else:
        q = _mm(copy(rms_norm(_mm(h, lw["wq_a"]), lw["q_a_norm"], eps)), lw["wq_b"])
    q = q.reshape(B, T, nh, dn + dr).transpose(1, 2)
    kv_a = _mm(h, lw["wkv_a"])  # [B, T, r + dr]
    latent = rms_norm(kv_a[..., :r], lw["kv_a_norm"], eps)
    k_pe = apply_rope_interleaved(kv_a[:, None, :, r:], cos, sin)  # [B, 1, T, dr]
    kv = _mm(copy(latent), lw["wkv_b"]).reshape(B, T, nh, dn + dv).transpose(1, 2)
    q = torch.cat([q[..., :dn], apply_rope_interleaved(q[..., dn:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :dn], copy(k_pe).expand(B, nh, T, dr)], dim=-1)
    return q, k, kv[..., dn:], torch.cat([latent, k_pe[:, 0]], dim=-1)


def local_config(cfg: LlamaConfig, params: dict) -> LlamaConfig:
    """The config a tree computes under: cfg itself for a whole tree, this
    rank's head counts for a tree of parallel.shard_llm_params (its Shard's
    `local`; a config already local is kept)."""
    shard = params.get("shard")
    return cfg if shard is None else shard.local(cfg)


def row_parallel(shard):
    """The Shard whose partial products the model code sums: None for a
    whole tree and for a model group of one rank, whose products are whole
    (so a one-rank mesh computes exactly what the unsharded tree does; its
    embedding, head gather and merge still run through the collectives)."""
    return shard if shard is not None and shard.m > 1 else None


def _block(cfg: LlamaConfig, x, lw, cos, sin, bias, cache_kv=None, cache_index: int = 0,
           plain: bool = False, key_mask=None, latent_out=None, shard=None):
    """One transformer block over x [B, T, H] with this layer's weights lw,
    every branch of dmi_tpu's _block: q/k/v biases (fused or not), olmo2's
    whole-width q/k norms before the head reshape and the per-head q/k
    norms before rope, MLA (`_mla_qkv`), gemma's post-block norms, olmo2's
    post-norm block (norm_after), granite's residual multiplier and the
    routed MLP of the MoE families (`_moe_mlp`).

    With cache_kv = (k_cache, v_cache) [B, nkv, S_max, hd] (serving; MLA's
    are expanded, nh heads, V at v_head_dim), the new k/v are written IN
    PLACE into the caches at cache_index, and attention reads the caches'
    first cache_index + T positions; bias is [T, cache_index + T] f32.
    T == 1 is a decode step: the CUDA kernel (its plain twin when `plain`,
    and always for MLA, whose K and V widths differ).

    With cache_kv None (training and the eval loss), attention is causal
    over x's T positions: with bias None through the flash attention
    kernels (the twin when `plain`), the keys masked by key_mask [B, T]
    (None: no key masked); else `_attention` with bias [B, T, T], which
    carries the key mask and, on a sliding layer, the window.  Nothing on
    this path is written in place, except that an MLA layer writes its
    compressed rows into latent_out [B, T, r + dr] when one is given (the
    batch-last loop's prefill).

    shard: lw is this rank's shard of the layer (parallel/sharding.py): the
    block computes its heads and MLP columns under the shard's local config
    and sums wo's and the MLP's partial products over the model group.
    Under autograd the normed h enters the column products through
    Shard.copy, whose backward sums the model ranks' partial gradients.

    Spans: llama.attn from the normed input to wo, then llama.moe
    (_moe_mlp) or llama.mlp, each with its backward range (`.bwd`)."""
    if shard is not None:
        cfg = shard.local(cfg)
    shard = row_parallel(shard)
    B, T, H = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps

    h = x if cfg.norm_after else rms_norm(x, lw["ln_attn"], eps)
    with region("llama.attn") as r:
        h = r.enter(h)
        if cfg.kv_lora_rank is not None:
            q, k, v, rows = _mla_qkv(cfg, lw, h, cos, sin, shard)
            if latent_out is not None:
                latent_out.copy_(rows)
        else:
            if shard is not None:
                h = shard.copy(h)
            if "w_qkv" in lw:  # fused layout (fuse_projections)
                qkv = _mm(h, lw["w_qkv"])
                if "b_qkv" in lw:
                    qkv = qkv + lw["b_qkv"]
                q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
            else:
                q, k, v = _mm(h, lw["wq"]), _mm(h, lw["wk"]), _mm(h, lw["wv"])
                if "bq" in lw:
                    q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
            if cfg.qk_norm_wide:  # olmo2: over the whole projection
                q, k = (rms_norm(q, lw["q_norm"], eps, shard),
                        rms_norm(k, lw["k_norm"], eps, shard))
            q = q.reshape(B, T, nh, hd).transpose(1, 2)
            k = k.reshape(B, T, nkv, hd).transpose(1, 2)
            v = v.reshape(B, T, nkv, hd).transpose(1, 2)
            if cfg.qk_norm:  # qwen3, gemma-3: per head, before rope
                q, k = rms_norm(q, lw["q_norm"], eps), rms_norm(k, lw["k_norm"], eps)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

        scale = attn_score_scale(cfg)
        cap = cfg.attn_logit_softcap
        if cache_kv is None and bias is None:
            attend = _flash_attn_plain if plain else flash_attention
            attn = attend(q, k, v, key_mask, scale)
        elif cache_kv is None:
            attn = _attention(q, k, v, bias, scale, cap)
        elif T == 1:
            k, v = _write_cache(cache_kv, cache_index, k, v)
            # MLA's K and V widths differ, which the kernel does not take:
            # dmi_tpu attends through XLA there, the port through the twin
            mla = cfg.kv_lora_rank is not None
            attend = _decode_attn_plain if plain or mla else fused_decode_attention
            attn = attend(q.contiguous(), k, v, bias[0], scale, cap)
        else:
            k, v = _write_cache(cache_kv, cache_index, k, v)
            attn = _attention(q, k, v, bias, scale, cap)
        attn = attn.transpose(1, 2).reshape(B, T, nh * attn.shape[-1])
        attn = r.leave(_mm(attn, lw["wo"], shard))
    x = x + _block_out(cfg, attn, lw, "ln_post_attn", "ln_attn")

    h = x if cfg.norm_after else rms_norm(x, lw["ln_mlp"], eps)
    if "w_router" in lw:  # the layer's kind, as its tree was built (moe_layer)
        out = _moe_mlp(cfg, lw, h, shard)
    else:
        with region("llama.mlp") as r:
            h = r.enter(h)
            if shard is not None:
                h = shard.copy(h)
            if "w_gu" in lw:  # fused layout
                gate, up = _mm(h, lw["w_gu"]).chunk(2, dim=-1)
            else:
                gate, up = _mm(h, lw["w_gate"]), _mm(h, lw["w_up"])
            out = r.leave(_mm(mlp_activation(cfg, gate) * up, lw["w_down"], shard))
    return x + _block_out(cfg, out, lw, "ln_post_mlp", "ln_mlp")


def _block_out(cfg: LlamaConfig, out, lw, post: str, after: str, norm=None):
    """A sub-block's output before its residual add: gemma's post norm lw[post],
    olmo2's norm lw[after] of the output, granite's residual multiplier.
    `norm` is the RMSNorm over the feature axis (the batch-last step passes
    its own)."""
    norm = norm or rms_norm
    if cfg.post_block_norms:
        out = norm(out, lw[post], cfg.rms_norm_eps)
    if cfg.norm_after:
        out = norm(out, lw[after], cfg.rms_norm_eps)
    if cfg.residual_multiplier is not None:
        out = out * in_dtype(cfg.residual_multiplier, out.dtype)
    return out


def forward(cfg: LlamaConfig, params: dict, inputs_embeds: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None, plain: bool = False,
            vocab_local: bool = False) -> torch.Tensor:
    """Full-sequence forward with no cache -> logits [B, T, V], through
    final_softcap (dmi_tpu's llama.forward, llama.py:1255-1379).

    attention_mask: [B, T] with 1 = real token (HF convention), or None for
    pure causal attention.  It masks keys only: pad queries still attend
    the real prefix (llama.py:1089-1095).  Positions are arange(T).  Where
    flash_route holds, attention runs the CUDA flash kernels for CUDA
    tensors, and their plain twin for CPU tensors or when `plain`;
    elsewhere (gemma's softcaps, a window that binds, dual rope) every
    layer runs `_attention` with the additive [B, T, T] bias, a sliding
    layer's with the window, and the rope tables of its kind.

    vocab_local: a sharded tree returns this rank's vocab shard [B, T,
    v1 - v0] of the logits, ungathered (the loss's input, causal_lm_nll;
    the whole vocab at m = 1); the final norm's output enters the head
    through Shard.copy.  A whole tree ignores it.

    Span llama.head (its backward llama.head.bwd): the final norm and the
    head; the layers take _block's spans."""
    B, T = inputs_embeds.shape[:2]
    shard = params.get("shard")
    x = scale_embeds(cfg, inputs_embeds.to(cfg.dtype))
    pos = torch.arange(T, device=x.device)
    rope = rope_tables(cfg, pos)
    rope_local = rope_tables(cfg, pos, local=True) if rope_dual(cfg) else None
    bias = bias_sw = None
    if not flash_route(cfg, T):
        valid = (pos[None, :] <= pos[:, None]).expand(B, T, T)
        if attention_mask is not None:
            valid = valid & attention_mask[:, None, :].bool()
        bias = torch.where(valid, 0.0, NEG_INF)
        if sliding_effective(cfg, T):
            bias_sw = torch.where(valid & window_mask(cfg, pos[:, None], pos), 0.0, NEG_INF)
    for i, lw in enumerate(params["layers"]):
        b, (cos, sin) = layer_inputs(cfg, i, bias, bias_sw, rope, rope_local)
        x = _block(cfg, x, lw, cos, sin, b, plain=plain, key_mask=attention_mask, shard=shard)
    with region("llama.head") as r:
        x = rms_norm(r.enter(x), params["final_norm"], cfg.rms_norm_eps)
        if not vocab_local or shard is None:
            return r.leave(final_softcap(cfg, _head_matmul(x, params, cfg)))
        if shard.m > 1:
            x = shard.copy(x)
        return r.leave(final_softcap(cfg, _head_matmul_local(x, params, cfg)))


def causal_lm_nll(logits: torch.Tensor, labels: torch.Tensor, groups: Optional[int] = None,
                  shard=None) -> tuple:
    """HF CausalLM loss's pieces: shift, ignore -100, the summed f32
    cross-entropy and the count of valid labels, whole ([]) or per group
    of G stacked micro-batches ([G]).  shard: logits are this rank's vocab
    shard of a tree over m > 1 model ranks (forward(vocab_local=True)),
    read by Shard.vocab_parallel_nll without a gather; otherwise the
    unsharded path."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    flat_logits = shift_logits.reshape(-1, shift_logits.shape[-1])
    if row_parallel(shard) is None:
        nll = F.cross_entropy(flat_logits, shift_labels.reshape(-1), ignore_index=-100,
                              reduction="sum" if groups is None else "none")
    else:
        nll = shard.vocab_parallel_nll(flat_logits, shift_labels.reshape(-1))
        if groups is None:
            nll = nll.sum()
    if groups is None:
        return nll, valid.sum()
    gb, t = shift_labels.shape
    return nll.reshape(groups, gb // groups * t).sum(1), valid.reshape(groups, -1).sum(1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, shard=None) -> torch.Tensor:
    """HF CausalLM loss: shift, ignore -100, token-mean cross-entropy in f32
    (dmi_tpu's llama.causal_lm_loss); 0 when no label is valid.  shard:
    vocab-sharded logits, as causal_lm_nll takes them.  Span train.loss
    (its backward train.loss.bwd)."""
    with region("train.loss") as r:
        nll, count = causal_lm_nll(r.enter(logits), labels, shard=shard)
        return r.leave(nll / count.clamp(min=1))


def causal_lm_loss_grouped(logits: torch.Tensor, labels: torch.Tensor,
                           groups: int, shard=None) -> torch.Tensor:
    """causal_lm_loss of G stacked micro-batches in one [G*B, T] forward ->
    [G] per-group token-mean losses, each equal to causal_lm_loss on that
    group's rows alone (dmi_tpu's llama.causal_lm_loss_grouped).  Rows padded
    past their own micro-batch length must carry -100 labels."""
    nll, count = causal_lm_nll(logits, labels, groups, shard)
    return nll / count.clamp(min=1)
