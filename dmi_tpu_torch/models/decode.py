"""Batched KV-cache greedy decode (counterpart of dmi_tpu/models/decode.py):
the batch-first loop and the batch-last loop, which is the serving default.

Replaces HF ``llm.generate(inputs_embeds=..., max_new_tokens=...,
pad_token_id=...)`` (reference: dmi/model/mmmodel.py:61-81,149-169) with
the default generation config, i.e. pure greedy, with HF's semantics:

  * with inputs_embeds, only the newly generated ids are returned
  * per-sequence finish on any EOS id; finished sequences emit pad_token_id
  * the terminating EOS itself is written before the sequence is padded

The caches are [L, B, nkv, S, hd] per K and V (MLA's expanded per head, V
at v_head_dim), preallocated at prompt length + max_new_tokens and written
in place; each step attends to the positions written so far.  The loops
stop when every row is done.

The sampled loops (sample_generate_bl, and sample_generate batch-first)
draw with request-indexed randomness: row r's token at age n is a pure
function of (seed, req_ids[r] * budget + n), as dmi_tpu's fold_in keys
are (_req_keys), so the batch loops and the continuous-batching engine
(streaming.py) draw identical tokens for a request whatever its row, batch
or slot.  The draw (uniform_draws) is a counter-based hash in integer
torch ops, so the CPU and the card give the same bits; JAX's threefry
streams are not reproduced, so the port's draws are held to dmi_tpu's by
their law, not bit for bit.

The batch-last loop (greedy_generate_bl) keeps a decode step's activations
as [features, B], the form its kernels take: the whole gated MLP in one
weight stream (ops/cuda/decode_mlp), the packed W4A8 and the W8A8 matmuls
(ops/cuda/w4_matmul) and the head fused with the argmax
(ops/cuda/head_argmax: the tied embed, or an untied bf16 lm_head's rows);
a quantized untied head takes _mm_bl(lm_head, h) and an argmax, as
dmi_tpu's loop does.  It serves unquantized trees and the three quantized
ones of models/quant.py, and every family's step (q/k/v biases, q/k norms,
post-block norms, post-norm blocks, granite's residual multiplier, a
sliding layer's window row, gemma-3's local rope, the MoE families' routed
MLP, deepseek-v2's absorbed MLA over a latent cache).  Prefill stays
batch-first and the K/V caches stay as prefill wrote them: the step
transposes only its own [nh*hd, B] tensors and attends through the
decode-attention kernel (ops/cuda/decode_attn).  MLA's latent cache is
[L, B, S, r + dr], one row per token for all heads.  dmi_tpu's merged
[L, 2, nkv, S, hd, B] cache, its windowed phase schedule and its two-token
unroll are TPU lane-layout and while_loop compile choices with no
counterpart here: the Python loop attends to the pos + 1 written positions,
which is token-exact.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models.llama import LlamaConfig
from dmi_tpu_torch.models.quant import dequantize, int_matmul, quantize_act, unpack_w4
from dmi_tpu_torch.ops.cuda.decode_attn import _decode_attn_plain, fused_decode_attention
from dmi_tpu_torch.ops.cuda.decode_mlp import _decode_mlp_plain, fused_decode_mlp_bl
from dmi_tpu_torch.ops.cuda.head_argmax import _head_argmax_plain, head_argmax, head_logits_bl
from dmi_tpu_torch.ops.cuda.w4_matmul import (_rescale, _w4_mm_plain, _w8_mm_plain, w4_mm_bl,
                                              w8_mm_bl)
from dmi_tpu_torch.utils import rng
from dmi_tpu_torch.utils.profiling import span

NEG_INF = llama.NEG_INF


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch-first K and V caches [L, B, nkv, S, hd].  MLA's are
    expanded per head, as dmi_tpu's: K at the q/k width (nkv == nh), V at
    v_head_dim."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len)
    v_dim = cfg.v_head_dim if cfg.kv_lora_rank is not None else cfg.head_dim
    return (torch.zeros(shape + (cfg.head_dim,), dtype=cfg.dtype, device=device),
            torch.zeros(shape + (v_dim,), dtype=cfg.dtype, device=device))


def init_latent_cache(cfg: LlamaConfig, batch: int, max_len: int, device="cpu") -> torch.Tensor:
    """MLA's compressed cache for the batch-last loop, [L, B, S, r + dr]:
    one row per token for all heads, [normed kv latent | roped shared key]
    (dmi_tpu's [L, 1, 1, S, r + dr, B] in the port's batch-first order)."""
    return torch.zeros((cfg.num_hidden_layers, batch, max_len,
                        cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype=cfg.dtype, device=device)


def _run_layers(cfg, params, x, rope, bias, caches, cache_index: int,
                last_only: bool = False, plain: bool = False, bias_sw=None, rope_local=None):
    """Every layer in turn over x, writing the caches in place; returns the
    head's logits through final_softcap (of the last position only when
    last_only: prefill needs just the next-token logits, and [B, T, V] is
    its largest tensor).  A sliding layer takes bias_sw (None while no
    window binds) and, with dual rope, rope_local (llama.layer_inputs)."""
    k_cache, v_cache = caches
    for i, lw in enumerate(params["layers"]):
        b, (cos, sin) = llama.layer_inputs(cfg, i, bias, bias_sw, rope, rope_local)
        x = llama._block(cfg, x, lw, cos, sin, b, (k_cache[i], v_cache[i]), cache_index,
                         plain=plain, shard=params.get("shard"))
    if last_only:
        x = x[:, -1:, :]
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return llama.final_softcap(cfg, llama._head_matmul(x, params, cfg))


def _window_row(cfg, pos: int, device):
    """A token step's [1, pos + 1] window bias over the written positions,
    or None while the window cannot bind there (sliding_effective)."""
    if not llama.sliding_effective(cfg, pos + 1):
        return None
    keys = torch.arange(pos + 1, device=device)
    return torch.where(llama.window_mask(cfg, pos, keys), 0.0, NEG_INF)[None]


def _local_rope(cfg, positions):
    return llama.rope_tables(cfg, positions, local=True) if llama.rope_dual(cfg) else None


def prefill(cfg, params, inputs_embeds, caches, plain: bool = False):
    """Run the uniform-length prompt, filling caches at positions [0, T);
    returns the next-token logits [B, V] (through final_softcap)."""
    T = inputs_embeds.shape[1]
    device = inputs_embeds.device
    positions = torch.arange(T, device=device)
    causal = positions[None, :] <= positions[:, None]  # [T, T]
    bias = torch.where(causal, 0.0, NEG_INF)
    bias_sw = None
    if llama.sliding_effective(cfg, T):
        in_win = llama.window_mask(cfg, positions[:, None], positions)
        bias_sw = torch.where(causal & in_win, 0.0, NEG_INF)
    x = llama.scale_embeds(cfg, inputs_embeds.to(cfg.dtype))
    logits = _run_layers(cfg, params, x, llama.rope_tables(cfg, positions), bias, caches, 0,
                         last_only=True, plain=plain, bias_sw=bias_sw,
                         rope_local=_local_rope(cfg, positions))
    return logits[:, -1, :]


def decode_step(cfg, params, token_embeds, caches, pos: int, plain: bool = False):
    """One token step writing absolute position `pos`; returns logits [B, V]
    (through final_softcap)."""
    device = token_embeds.device
    positions = torch.tensor([pos], device=device)
    # all valid: each layer attends to a view of the pos + 1 written positions
    bias = torch.zeros((1, pos + 1), dtype=torch.float32, device=device)
    x = llama.scale_embeds(cfg, token_embeds.to(cfg.dtype))
    logits = _run_layers(cfg, params, x, llama.rope_tables(cfg, positions), bias, caches, pos,
                         plain=plain, bias_sw=_window_row(cfg, pos, device),
                         rope_local=_local_rope(cfg, positions))
    return logits[:, 0, :]


@torch.no_grad()
def greedy_generate(
    cfg: LlamaConfig,
    params: dict,
    inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    plain: bool = False,
) -> torch.Tensor:
    """Greedy decode from a uniform-length prompt of embeddings [B, T, H].

    The batch-first loop.  Returns [B, max_new_tokens] int64 generated ids
    (pad-filled after a row's EOS).  plain=True runs the decode attention's
    plain twin in place of the CUDA kernel (a reference path for
    comparisons on the card).  A sharded tree (parallel.shard_llm_params)
    decodes its shard under its local config; every model rank returns the
    same ids."""
    cfg = llama.local_config(cfg, params)
    B, T, _ = inputs_embeds.shape
    device = inputs_embeds.device
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    if max_new_tokens == 0:
        return tokens
    caches = init_cache(cfg, B, T + max_new_tokens, device)
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=device)
    logits = prefill(cfg, params, inputs_embeds, caches, plain=plain)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    step = 0
    # iteration k consumes the previous logits and computes the next ones,
    # so only max_new_tokens - 1 decode steps run: the last token is an
    # argmax of the last logits.  With no EOS ids no row can finish, and
    # the loop skips the host sync that the all-done test costs.
    while step < max_new_tokens - 1 and not (eos.numel() and bool(done.all())):
        next_tok = torch.where(done, pad_token_id, logits.argmax(dim=-1))
        tokens[:, step] = next_tok
        done |= torch.isin(next_tok, eos)
        embeds = llama.embed_tokens(cfg, params, next_tok)[:, None, :]
        logits = decode_step(cfg, params, embeds, caches, T + step, plain=plain)
        step += 1
    tokens[:, step] = torch.where(done, pad_token_id, logits.argmax(dim=-1))
    return tokens


# ---------------------------------------------------------------------------
# Request-indexed sampling
# ---------------------------------------------------------------------------

# the counter-based hash of the draws (shared with utils.rng's CounterRNG)
_M32, _mul32, _fmix32 = rng.M32, rng.mul32, rng.fmix32


def _req_keys(seed: int, req_ids: torch.Tensor, budget: int, n) -> torch.Tensor:
    """Per-row draw keys [B] (int64 in [0, 2**32)) of (seed, stream), stream
    = req_ids * budget + n: a request's age-n draw whatever its row, batch
    or slot (dmi_tpu's _req_keys, fold_in(key(seed), req * budget + n)).
    n is one age (the batch loops) or [B] ages (the engine's slots).  The
    seed and the stream's two 32-bit halves go through _fmix32 in turn."""
    stream = req_ids.long() * budget + n
    h = _fmix32(torch.full_like(stream, (int(seed) ^ 0x9E3779B9) & _M32))
    h = _fmix32(h ^ (stream & _M32))
    return _fmix32(h ^ ((stream >> 32) & _M32))


def uniform_draws(keys: torch.Tensor, V: int) -> torch.Tensor:
    """The draw: u[v, b] in the open interval (0, 1), f64 [V, B], of row
    key keys[b] and token index v, with 24 random bits:

        u = ((fmix32(keys[b] ^ fmix32(v ^ 0x7F4A7C15)) >> 8) + 1/2) / 2**24

    A stateless counter-based function in integer ops (no generator whose
    state would make a row's draws depend on the rows beside it), so the
    CPU and the card give the same bits.  Each fmix32 is a bijection, so
    two token indices of a row never share their 32-bit hash."""
    v = torch.arange(V, dtype=torch.long, device=keys.device)
    h = _fmix32(keys.long()[None, :] ^ _fmix32(v ^ 0x7F4A7C15)[:, None])
    return ((h >> 8).double() + 0.5) * 2.0 ** -24


def _gumbel_pick(warped_vb: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Gumbel-max over [V, B] warped logits: argmax_v(warped - log(-log u)),
    a draw from softmax(warped) per column, the law of
    jax.random.categorical.  A filtered token (-inf) is never picked;
    ties go to the first index.  -> [B] int64."""
    u = uniform_draws(keys, warped_vb.shape[0])
    g = (-torch.log(-torch.log(u))).float()
    return (warped_vb + g).argmax(dim=0)


def _warp_bl(logits_vb: torch.Tensor, temperature: float, top_k: int,
             top_p: float = 1.0) -> torch.Tensor:
    """dmi_tpu's _warp_bl: HF's warp chain over batch-last [V, B] logits,
    in HF's order: temperature (at least 1e-6), then top-k (masks scores
    below the k-th largest, so ties at the k-th value stay), then top-p
    (keeps the smallest prefix of tokens in descending order whose
    probability reaches top_p, the token that crosses it included, and every
    token equal to that cutoff).  Returns f32 [V, B], -inf where filtered.
    torch.topk gives the k-th value in place of a full sort; the mask is
    the same."""
    scaled = logits_vb.float() / max(temperature, 1e-6)
    V = scaled.shape[0]
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, V), dim=0).values[-1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p < 1.0:
        # per column, as [B, V] rows: the card's softmax and cumsum over the
        # leading axis of [V, B] took 100x longer than over rows
        desc = torch.sort(scaled.t(), dim=1, descending=True).values
        exceeded = torch.cumsum(torch.softmax(desc, dim=1), dim=1) > top_p
        keep = torch.cat([torch.ones_like(exceeded[:, :1]), ~exceeded[:, :-1]], dim=1)
        kth_p = torch.where(keep, desc, float("inf")).amin(dim=1)
        scaled = scaled.masked_fill(scaled < kth_p[None, :], float("-inf"))
    return scaled


def _sample_pick_bl(logits_vb: torch.Tensor, keys: torch.Tensor, temperature: float,
                    top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """One token per column of [V, B] logits: the _warp_bl chain, then the
    Gumbel-max draw with the column's key -> [B] int64."""
    return _gumbel_pick(_warp_bl(logits_vb, temperature, top_k, top_p), keys)


@torch.no_grad()
def sample_generate(
    cfg: LlamaConfig,
    params: dict,
    inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    seed: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    prefill_params: Optional[dict] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Sampled decode (temperature, top-k) on the batch-first loop, with
    greedy_generate's cache and EOS/pad semantics -> [B, max_new_tokens].

    Row r's token at age n is drawn with _req_keys(seed, r, max_new_tokens,
    n), the batch-last loop's request-indexed draw with req = row, so the
    two loops' sampled tokens can be compared.  dmi_tpu's sample_generate
    splits one key per step instead (the draws then depend on the batch)."""
    cfg = llama.local_config(cfg, params)
    B, T, _ = inputs_embeds.shape
    device = inputs_embeds.device
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    if max_new_tokens == 0:
        return tokens
    caches = init_cache(cfg, B, T + max_new_tokens, device)
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=device)
    logits = prefill(cfg, params if prefill_params is None else prefill_params,
                     inputs_embeds, caches, plain=plain)
    rows = torch.arange(B, device=device)

    def pick(logits, step):
        keys = _req_keys(seed, rows, max_new_tokens, step)
        return _sample_pick_bl(logits.t(), keys, temperature, top_k)

    done = torch.zeros(B, dtype=torch.bool, device=device)
    step = 0
    while step < max_new_tokens - 1 and not (eos.numel() and bool(done.all())):
        next_tok = torch.where(done, pad_token_id, pick(logits, step))
        tokens[:, step] = next_tok
        done |= torch.isin(next_tok, eos)
        embeds = llama.embed_tokens(cfg, params, next_tok)[:, None, :]
        logits = decode_step(cfg, params, embeds, caches, T + step, plain=plain)
        step += 1
    tokens[:, step] = torch.where(done, pad_token_id, pick(logits, step))
    return tokens


# ---------------------------------------------------------------------------
# Batch-last decode: activations [features, B]
# ---------------------------------------------------------------------------

def _rotate_half_rows(x):
    """llama._rotate_half over the second-to-last axis: x [..., hd, B]."""
    half = x.shape[-2] // 2
    return torch.cat([-x[..., half:, :], x[..., :half, :]], dim=-2)


def _rope_bl(x, cos, sin):
    """Rope for batch-last tensors.  x [..., hd, B]; cos/sin [hd] for one
    shared position, or [hd, B] for per-slot positions; computed in f32."""
    c = (cos[:, None] if cos.ndim == 1 else cos).float()
    s = (sin[:, None] if sin.ndim == 1 else sin).float()
    xf = x.float()
    return (xf * c + _rotate_half_rows(xf) * s).to(x.dtype)


def _rope_interleaved_bl(x, cos, sin):
    """Deepseek's interleaved rope for batch-last tensors: adjacent rows
    (x[2j], x[2j+1]) rotate as complex pairs (llama.apply_rope_interleaved).
    x [..., d, B]; cos/sin the duplicated [d] tables of one shared position
    or [d, B] per slot, pair j reading entry j; computed in f32."""
    d2 = x.shape[-2] // 2
    c = (cos[:, None] if cos.ndim == 1 else cos)[:d2].float()
    s = (sin[:, None] if sin.ndim == 1 else sin)[:d2].float()
    xf = x.float()
    even, odd = xf[..., 0::2, :], xf[..., 1::2, :]
    # pairs stacked after d2: the (d2, 2) flattening restores the row order
    out = torch.stack([even * c - odd * s, odd * c + even * s], dim=-2)
    return out.reshape(x.shape).to(x.dtype)


def _rms_norm_bl(x, scale, eps, shard=None):
    """rms_norm over the leading (feature) axis of a batch-last [H, B]
    (shard: a whole-width norm over this rank's rows, as llama.rms_norm)."""
    xf = x.float()
    if shard is None:
        var = (xf * xf).mean(dim=0, keepdim=True)
    else:
        var = shard.psum((xf * xf).sum(dim=0, keepdim=True)) / (x.shape[0] * shard.m)
    return (xf * torch.rsqrt(var + eps) * scale.float()[:, None]).to(x.dtype)


def _mm_bl(w, h, plain: bool = False, shard=None):
    """Batch-last matmul: w [in, out] (or a quantized dict of
    models/quant.py), h [in, B] -> [out, B]; equals (h^T @ w)^T.

    "q8" and per-channel "qp" weights quantize the activations per token and
    run the int8 kernels of ops/cuda/w4_matmul (their twins when `plain`);
    grouped "qp" weights ("s4g") unpack and run G partial products weighted
    by their groups' scales, which dmi_tpu also computes outside its kernel;
    "q" weights are widened to h's dtype per call (eager torch materialises
    the widened copy that XLA fuses into its dot).

    shard: w is row-parallel (wo, w_down: its rows this rank's slice of the
    contraction).  The partial products are summed in f32 over the model
    group and rounded once to h's dtype, never per rank; the activations
    take the amax over all of the contraction, so hq and a are the one-rank
    ones.  The int8 kernels run their f32 instance with unit scales, so
    their partials are the integer accumulators (exact in f32 below 2**24):
    their sum, rescaled in the kernel's order, is the one-rank product bit
    for bit."""
    if shard is None:
        def red(t):
            return t
    else:
        def red(t):
            return shard.psum(t.float())
    if not isinstance(w, dict):
        return w.t() @ h if shard is None else red(w.float().t() @ h.float()).to(h.dtype)
    if "q" in w:
        if shard is None:
            return (w["q"].to(h.dtype).t() @ h) * w["s"].to(h.dtype).reshape(-1, 1)
        return (red(w["q"].float().t() @ h.float()).to(h.dtype)
                * w["s"].to(h.dtype).reshape(-1, 1))
    if "q8" not in w and "qp" not in w:
        raise ValueError(f"unknown quantized dict keys {sorted(w)}")
    hq, a = quantize_act(h, axis=0, reduce=None if shard is None else shard.pmax)  # a [1, B]
    if "s4g" in w:
        q8 = unpack_w4(w["qp"])
        s4g = w["s4g"]  # [G, out]
        G, K = s4g.shape[0], q8.shape[0]
        qg = q8.reshape(G, K // G, q8.shape[1])
        hg = hq.reshape(G, K // G, hq.shape[1])
        acc = int_matmul(qg.transpose(1, 2), hg)  # [G, out, B]
        return (red((acc * s4g[:, :, None]).sum(dim=0)) * a).to(h.dtype)
    if "q8" in w:
        mm = _w8_mm_plain if plain else w8_mm_bl
    else:
        mm = _w4_mm_plain if plain else w4_mm_bl
    if shard is None:
        return mm(w, hq, a, h.dtype)
    unit = {k: torch.ones_like(v) if k == "s" else v for k, v in w.items()}
    return _rescale(red(mm(unit, hq, torch.ones_like(a), torch.float32)), w["s"], a, h.dtype)


def _moe_mlp_bl(cfg, lw, hn, plain: bool = False, shard=None):
    """The dense-evaluated sparse-MoE MLP, batch-last (dmi_tpu's
    _moe_mlp_bl): hn [H, B] -> [H, B], llama._moe_mlp's formula
    transposed: g = W1 hn and u = W3 hn over the stacks viewed [E * I, H]
    (llama.expert_stacks), z = act(g) * u * w_e, out = W2^T z, so no
    [E, H, B] tensor is formed.  The router product runs in the model dtype
    (f32 with moe_gate_fp32); the expert products are torch ops (as
    dmi_tpu's XLA einsums; no kernel); deepseek's shared experts go through
    _mm_bl, so a quantized tree runs them on the int8 kernels.  shard: this
    rank's experts and shared-expert slice, as llama._moe_mlp; the experts
    held are llama.held_experts' (a config's expert-parallel share adds
    its own experts' part alone).  Span decode.moe, the router product and
    gate weights inside it moe.route."""
    with span("decode.moe"):
        with span("moe.route"):
            if cfg.moe_gate_fp32:
                router = dequantize(lw["w_router"], torch.float32).float().t() @ hn.float()
            else:
                router = _mm_bl(lw["w_router"], hn, plain)  # [E, B]
            w_e = llama.moe_gate_weights(cfg, router.t(), lw.get("router_bias"))
            w_e = w_e.t().to(hn.dtype)  # [E, B]
        held = llama.held_experts(cfg, shard)
        if held is not None:
            w_e = w_e[held]
        w1, w3, w2 = llama.expert_stacks(lw, hn.dtype)
        E, I, H = w2.shape
        g = w1.reshape(E * I, H) @ hn  # [E * I, B]
        u = w3.reshape(E * I, H) @ hn
        z = (llama.mlp_activation(cfg, g) * u).view(E, I, -1) * w_e[:, None, :]
        out = w2.reshape(E * I, H).t() @ z.view(E * I, -1)  # [H, B]
        if shard is not None:
            out = shard.psum(out.float()).to(hn.dtype)
        if cfg.n_shared_experts:
            gate = llama.mlp_activation(cfg, _mm_bl(lw["w_shared_gate"], hn, plain))
            out = out + _mm_bl(lw["w_shared_down"], gate * _mm_bl(lw["w_shared_up"], hn, plain),
                               plain, shard)
        return out


def _mla_attn_bl(cfg, lw, hn, latent, row: int, span: int, bias, cos, sin,
                 plain: bool = False):
    """Absorbed MLA attention of one token step over the compressed cache
    (dmi_tpu's _mla_attn_bl, the DeepSeek-V2 deployment form).  The cache
    holds one row per token for all heads, [normed latent (r) | roped
    shared key (dr)], and attention runs in the latent space by absorbing
    wkv_b:

        scores[h, s] = [Wb_k[h]^T q_nope[h] | q_pe[h]] . row[s]
        out[h]       = Wb_v[h]^T (sum_s probs[h, s] latent[s])

    hn [H, B] normed input; latent this layer's [B, S, r + dr] cache, whose
    row `row` this step writes in place and whose first `span` rows it
    reads; bias [span] or [B, span] f32; cos/sin [dr] or [dr, B].  The
    products are torch ops (dmi_tpu computes them in XLA), the scores and
    the context summed in f32 from model-dtype operands, the softmax in f32.
    Returns the attention output [nh * dv, B]."""
    nh = cfg.num_attention_heads
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv = cfg.v_head_dim
    B = hn.shape[1]
    if "wq" in lw:  # the Lite layout: a plain q projection
        q = _mm_bl(lw["wq"], hn, plain)
    else:
        qa = _rms_norm_bl(_mm_bl(lw["wq_a"], hn, plain), lw["q_a_norm"], cfg.rms_norm_eps)
        q = _mm_bl(lw["wq_b"], qa, plain)
    q = q.reshape(nh, dn + dr, B)
    q_pe = _rope_interleaved_bl(q[:, dn:], cos, sin)
    kv_a = _mm_bl(lw["wkv_a"], hn, plain)  # [r + dr, B]
    lat = _rms_norm_bl(kv_a[:r], lw["kv_a_norm"], cfg.rms_norm_eps)
    k_pe = _rope_interleaved_bl(kv_a[r:], cos, sin)
    latent[:, row] = torch.cat([lat, k_pe], dim=0).t()
    cache = latent[:, :span].float()  # [B, S, r + dr]

    # wkv_b is read once a step either way: absorbed into q and the output
    wkv_b = dequantize(lw["wkv_b"], hn.dtype).reshape(r, nh, dn + dv)
    q_eff = torch.einsum("rhd,hdb->hrb", wkv_b[:, :, :dn], q[:, :dn])  # [nh, r, B]
    q_abs = torch.cat([q_eff, q_pe], dim=1)  # [nh, r + dr, B]
    scores = cache @ q_abs.permute(2, 1, 0).float()  # [B, S, nh]
    scores = scores * llama.attn_score_scale(cfg)
    b = bias[None, :, None] if bias.ndim == 1 else bias[:, :, None]
    probs = torch.softmax(scores + b, dim=1).to(hn.dtype)
    ctx = (probs.float().transpose(1, 2) @ cache[:, :, :r]).to(hn.dtype)  # [B, nh, r]
    v_out = torch.einsum("rhv,bhr->hvb", wkv_b[:, :, dn:], ctx)
    return v_out.reshape(nh * dv, B)


def _mla_prefill_compressed(cfg, params, inputs_embeds, total: int, plain: bool = False):
    """MLA's prompt pass for the batch-last loop and the slot engine
    (dmi_tpu's _mla_prefill_compressed): the batch-first prefill through
    llama._block's expanded attention, each layer writing its compressed
    rows into the latent cache [L, B, total, r + dr] that _mla_attn_bl
    reads.  Returns (next-token logits [B, V] through final_softcap, the
    cache)."""
    B, T, _ = inputs_embeds.shape
    device = inputs_embeds.device
    positions = torch.arange(T, device=device)
    bias = torch.where(positions[None, :] <= positions[:, None], 0.0, NEG_INF)
    cos, sin = llama.rope_tables(cfg, positions)
    latent = init_latent_cache(cfg, B, total, device)
    x = llama.scale_embeds(cfg, inputs_embeds.to(cfg.dtype))
    for i, lw in enumerate(params["layers"]):
        x = llama._block(cfg, x, lw, cos, sin, bias, plain=plain, latent_out=latent[i, :, :T],
                         shard=params.get("shard"))
    x = llama.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_norm_eps)
    logits = llama.final_softcap(cfg, llama._head_matmul(x, params, cfg))
    return logits[:, 0], latent


def _decode_attention_bl(q, kc, vc, bias, scale=None, softcap=None):
    """Single-position GQA attention, batch-last (dmi_tpu's
    _decode_attention_bl): products in the input dtype with f32
    accumulation, f32 softmax.

    q [nkv, g, hd, B], kc/vc [nkv, S, hd, B], bias [S] (position validity
    shared by the batch) or [S, B] (per-slot positions) -> [nkv, g, hd, B].
    The decode step attends through the decode-attention kernel over the
    batch-first cache instead; this is the form over a batch-last cache
    that a continuous-batching engine shares."""
    scores = (q[:, :, None, :, :] * kc[:, None, :, :, :]).sum(dim=3, dtype=torch.float32)
    scores = scores * (scale if scale is not None else 1.0 / math.sqrt(q.shape[2]))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    b = bias[None, None, :, None] if bias.ndim == 1 else bias[None, None]
    probs = torch.softmax(scores + b, dim=2).to(vc.dtype)
    out = (probs[:, :, :, None, :] * vc[:, None, :, :, :]).sum(dim=2, dtype=torch.float32)
    return out.to(vc.dtype)


def _rms_norm_head_bl(x, scale, eps):
    """rms_norm over the head axis (-2) of batch-last per-head tensors
    [..., hd, B]; scale [hd] (the per-head q/k norms)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-2, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()[:, None]).to(x.dtype)


def _decode_step_bl(cfg, params, h, caches, pos: Optional[int], head: bool = True,
                    plain: bool = False, *, rope=None, write_row: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None, bias_sw: Optional[torch.Tensor] = None,
                    rope_local=None):
    """One batch-last token step with every branch of dmi_tpu's
    _decode_step_bl (q/k/v biases, both q/k norms, post-block norms,
    norm_after, the residual multiplier, a sliding layer's window bias,
    gemma-3's local rope, absorbed MLA and the routed MLP).  h [H, B];
    caches ([L, B, nkv, S, hd] x 2) as prefill wrote them, or for MLA the
    latent cache [L, B, S, r + dr] (init_latent_cache), written IN PLACE at
    absolute position `pos`.  Returns the logits [V, B] without
    final_softcap (greedy consumers need only their argmax; the sampler
    caps them), or with head=False the final norm's output [H, B] for the
    fused head + argmax.  The head is the tied embed (head_logits_bl) or
    the untied lm_head through _mm_bl.

    rope / write_row / bias / bias_sw / rope_local: the continuous-batching
    engine (streaming.py) shares this step with per-slot positions
    (dmi_tpu's rope=, write_row=, [S, B] bias and bias_sw, rope_local):
    per-slot rope tables (cos, sin) [rope_dim, B] (and the local ones with
    dual rope), the shared ring row every slot writes, and [B, S] f32
    biases over the whole fixed-length cache (0 on a slot's own entries,
    within the window for bias_sw, finfo.min elsewhere), which each layer
    attends over through the decode-attention kernel's per-row bias (MLA:
    _mla_attn_bl's); pos is then unused.  Without them the step attends to
    a view of the pos + 1 written positions with a zero [pos + 1] row, and
    on sliding layers the window's row once the window binds, as the batch
    loops always have.

    P query positions per cache row (the speculative verify forward,
    speculative._verify_step_bl): h [H, P * B] with lane p * B + b the
    position p of cache row b, rope tables [rope_dim, P * B], [B, P, S]
    biases (a causal row per position); the step writes the P positions'
    K/V at rows write_row .. write_row + P - 1 and attends through the
    decode-attention kernel with P positions (K3).  Every matmul, the MLP
    and the head run over the P * B lanes, so each weight is read once for
    all P positions.  Not for MLA (dmi_tpu refuses MLA speculation).

    On CUDA tensors an unquantized fused w_gu runs the decode-MLP kernel
    with cfg.mlp_act, quantized weights the int8 kernels (_mm_bl) and
    attention the decode-attention kernel on the step's transposed q/k/v;
    MoE layers take _moe_mlp_bl and MLA layers _mla_attn_bl (torch ops, as
    dmi_tpu's XLA); plain=True runs every kernel's plain twin instead.

    A sharded tree (parallel.shard_llm_params) steps its shard under its
    local config: the kernels run at this rank's heads and MLP columns, wo's
    and the MLP's partial outputs are summed over the model group (the int8
    kernels' in f32), and the vocab-sharded logits are gathered; the final
    norm's output (head=False) is replicated, for the fused head's merge.

    Each layer takes the MLP its tree holds (llama.moe_layer: a w_router
    means the routed MLP), so a stack may mix the two (deepseek's leading
    dense layers).

    Spans, each layer: decode.attn from the q/k/v products (or
    _mla_attn_bl) to wo, then decode.moe (_moe_mlp_bl) or decode.mlp (the
    dense MLP); then decode.head over the final norm and the head."""
    cfg = llama.local_config(cfg, params)
    shard = params.get("shard")
    rows = llama.row_parallel(shard)
    mla = cfg.kv_lora_rank is not None
    k_cache, v_cache = (caches, None) if mla else caches
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    g = nh // nkv
    B = k_cache.shape[1]  # cache rows; h holds P lanes a row
    N = h.shape[1]
    P = N // B
    s_total = k_cache.shape[2] if mla else k_cache.shape[3]
    per_slot = (rope is not None, write_row is not None, bias is not None)
    if any(per_slot) and not all(per_slot):
        raise ValueError("per-slot decode step: pass rope, write_row and bias together")
    if N != P * B or (P > 1 and (mla or rope is None)):
        raise ValueError(f"decode step: {N} lanes over {B} cache rows (P positions a row take "
                         "the per-slot arguments and no MLA)")
    if rope is None:
        positions = torch.tensor(pos, device=h.device)
        rope = llama.rope_tables(cfg, positions)  # [rope_dim] each
        rope_local = _local_rope(cfg, positions)
        # all valid: each layer attends to a view of the pos + 1 written positions
        bias = torch.zeros(pos + 1, dtype=torch.float32, device=h.device)
        window = _window_row(cfg, pos, h.device)
        bias_sw = None if window is None else window[0]
        row, s_read = pos, pos + 1
    else:
        want = (B, s_total) if P == 1 else (B, P, s_total)
        if bias.shape != want:
            raise ValueError(f"per-slot bias {tuple(bias.shape)}: [B, (P,) S] = {want}")
        if llama.rope_dual(cfg) and rope_local is None:
            raise ValueError("a dual-rope config (gemma-3) needs rope_local beside rope")
        row, s_read = write_row, s_total
    scale = llama.attn_score_scale(cfg)
    attend = _decode_attn_plain if plain else fused_decode_attention
    mlp = _decode_mlp_plain if plain else fused_decode_mlp_bl

    def mm(w, x):
        return _mm_bl(w, x, plain=plain)

    x = h
    for li, lw in enumerate(params["layers"]):
        b, (cos, sin) = llama.layer_inputs(cfg, li, bias, bias_sw, rope, rope_local)
        hn = x if cfg.norm_after else _rms_norm_bl(x, lw["ln_attn"], eps)
        with span("decode.attn"):
            if mla:
                attn = _mla_attn_bl(cfg, lw, hn, k_cache[li], row, s_read, b, cos, sin, plain)
            else:
                if "w_qkv" in lw:
                    qkv = mm(lw["w_qkv"], hn)
                    if "b_qkv" in lw:
                        qkv = qkv + lw["b_qkv"][:, None]
                    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=0)
                else:
                    q, k, v = mm(lw["wq"], hn), mm(lw["wk"], hn), mm(lw["wv"], hn)
                    if "bq" in lw:
                        q, k, v = (q + lw["bq"][:, None], k + lw["bk"][:, None],
                                   v + lw["bv"][:, None])
                if cfg.qk_norm_wide:
                    q = _rms_norm_bl(q, lw["q_norm"], eps, rows)
                    k = _rms_norm_bl(k, lw["k_norm"], eps, rows)
                q, k = q.reshape(nkv, g, hd, N), k.reshape(nkv, hd, N)
                if cfg.qk_norm:
                    q = _rms_norm_head_bl(q, lw["q_norm"], eps)
                    k = _rms_norm_head_bl(k, lw["k_norm"], eps)
                q, k = _rope_bl(q, cos, sin), _rope_bl(k, cos, sin)
                # only the step's own tensors change layout: [.., hd, P, B] -> [B, .., P, hd]
                k_cache[li][:, :, row:row + P] = k.reshape(nkv, hd, P, B).permute(3, 0, 2, 1)
                v_cache[li][:, :, row:row + P] = v.reshape(nkv, hd, P, B).permute(3, 0, 2, 1)
                attn = attend(q.reshape(nh, hd, P, B).permute(3, 0, 2, 1),
                              k_cache[li][:, :, :s_read], v_cache[li][:, :, :s_read], b,
                              scale, cfg.attn_logit_softcap)  # [B, nh, P, hd]
                attn = attn.permute(1, 3, 2, 0).reshape(nh * hd, N).contiguous()
            attn = _mm_bl(lw["wo"], attn, plain, rows)
        x = x + llama._block_out(cfg, attn, lw, "ln_post_attn", "ln_attn", _rms_norm_bl)
        hn = x if cfg.norm_after else _rms_norm_bl(x, lw["ln_mlp"], eps)
        if "w_router" in lw:  # never the decode-MLP kernel, as in dmi_tpu
            mlp_out = _moe_mlp_bl(cfg, lw, hn, plain, rows)
        else:
            with span("decode.mlp"):
                if "w_gu" in lw and not isinstance(lw["w_gu"], dict):
                    # the whole MLP in one weight stream
                    mlp_out = mlp(lw["w_gu"], lw["w_down"], hn, cfg.mlp_act)
                    if rows is not None:  # the kernel emits h's dtype: summed in f32
                        mlp_out = rows.psum(mlp_out.float()).to(hn.dtype)
                elif "w_gu" in lw:  # quantized layouts go through _mm_bl
                    gate, up = mm(lw["w_gu"], hn).chunk(2, dim=0)
                    mlp_out = _mm_bl(lw["w_down"], llama.mlp_activation(cfg, gate) * up, plain,
                                     rows)
                else:
                    gate = llama.mlp_activation(cfg, mm(lw["w_gate"], hn))
                    mlp_out = _mm_bl(lw["w_down"], gate * mm(lw["w_up"], hn), plain, rows)
        x = x + llama._block_out(cfg, mlp_out, lw, "ln_post_mlp", "ln_mlp", _rms_norm_bl)
    with span("decode.head"):
        x = _rms_norm_bl(x, params["final_norm"], eps)
        if not head:
            return x
        if cfg.tie_word_embeddings:
            logits = head_logits_bl(params["embed"], x)
        else:
            logits = mm(params["lm_head"], x)
        return logits if shard is None else shard.gather_vocab(logits, 0)


def fused_head_weights(cfg: LlamaConfig, params: dict) -> Optional[dict]:
    """The tree the fused head + argmax reads ({"embed": [V, H] rows, bf16
    or quantized}) where the model's head can take it, else None: the tied
    embed, or an untied bf16 lm_head [H, V] transposed into rows (one copy
    a call; dmi_tpu keeps an untied head on its logits path, and the argmax
    of the same bf16 logits is the same function).  A quantized untied head
    ({"q"|"q8"|"qp", "s" [1, V]}) takes _mm_bl and an argmax.  A sharded
    tree's rows are its vocab block, and the tree carries its Shard along
    for head_ids' merge.  Span decode.head_rows: the untied head's copy."""
    if cfg.dtype != torch.bfloat16:
        return None
    if cfg.tie_word_embeddings:
        head_w = {"embed": params["embed"]}
    elif isinstance(params["lm_head"], dict):
        return None
    else:
        with span("decode.head_rows"):
            head_w = {"embed": params["lm_head"].t().contiguous()}
    if "shard" in params:
        head_w["shard"] = params["shard"]
    return head_w


def head_ids(head_w: dict, out: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Greedy ids [B] of the final norm's output out [H, B] through the
    fused head + argmax over head_w (fused_head_weights), or its plain twin
    when `plain`.  A sharded head's kernel also writes each column's
    winning score, and the shards' (score, id) pairs are merged over the
    model group (Shard.argmax: the higher score, then the smaller global
    id, as the whole head's argmax).  Span decode.head, as the step's final
    norm."""
    with span("decode.head"):
        shard = head_w.get("shard")
        if shard is None:
            return _head_argmax_plain(head_w["embed"], out) if plain else head_argmax(head_w, out)
        if plain:
            ids, scores = _head_argmax_plain(head_w["embed"], out, scores=True)
        else:
            ids, scores = head_argmax(head_w, out, scores=True)
        return shard.argmax(scores, ids)


def _prefill_caches(cfg, params, inputs_embeds, total: int, plain: bool = False):
    """The batch-last loops' prompt pass: (caches sized for `total`
    positions, next-token logits [B, V]).  MLA fills the latent cache
    through _mla_prefill_compressed; the others fill the K/V caches through
    prefill.  Span decode.prefill (the layers take llama._block's)."""
    with span("decode.prefill"):
        cfg = llama.local_config(cfg, params)
        if cfg.kv_lora_rank is not None:
            logits, latent = _mla_prefill_compressed(cfg, params, inputs_embeds, total, plain)
            return latent, logits
        caches = init_cache(cfg, inputs_embeds.shape[0], total, inputs_embeds.device)
        return caches, prefill(cfg, params, inputs_embeds, caches, plain=plain)


@torch.no_grad()
def greedy_generate_bl(
    cfg: LlamaConfig,
    params: dict,
    inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    prefill_params: Optional[dict] = None,
    fused_head: Optional[bool] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Batch-last greedy decode from a uniform-length prompt of embeddings
    [B, T, H]: token-identical to greedy_generate (the same f32-accumulated
    attention contract, the same EOS/pad semantics), and the serving default
    (mmmodel.caption_generate).  Returns [B, max_new_tokens] int64 ids.

    prefill_params: separate weights for the prompt pass.  With W8A8 or
    W4A8 loop weights the compute-bound prefill gains nothing from int8 and
    pays the activation quantization per matmul, so the serving layer passes
    the unquantized originals here and keeps the loop's smaller weight
    stream (one more weight copy in device memory).

    fused_head: run the fused head + argmax (ops/cuda/head_argmax) so the
    loop never forms [V, B] logits; None resolves to a bf16 model whose head
    it can read (fused_head_weights: the tied embed or an unquantized
    untied lm_head; the kernel bakes in bf16 score rounding to match the
    logits path, so an f32 model takes logits + argmax, as does a quantized
    untied head, through _mm_bl).  plain=True runs every kernel's plain
    twin (a reference path for comparisons on the card).

    MLA (deepseek-v2) prefills through _mla_prefill_compressed and steps
    over the latent cache (absorbed attention), as dmi_tpu's loop does.
    A sharded tree (parallel.shard_llm_params) decodes its shard; every
    model rank returns the same ids."""
    cfg = llama.local_config(cfg, params)
    B, T, _ = inputs_embeds.shape
    device = inputs_embeds.device
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    if max_new_tokens == 0:
        return tokens
    head_w = fused_head_weights(cfg, params)
    if fused_head is None:
        fused_head = head_w is not None
    if fused_head and head_w is None:
        if not cfg.tie_word_embeddings:
            raise ValueError("the fused head + argmax reads a bf16 model's tied embed or "
                             "unquantized untied lm_head; this untied head takes the logits "
                             "path (fused_head=False)")
        head_w = {"embed": params["embed"]}  # head_argmax refuses an f32 state
        if "shard" in params:
            head_w["shard"] = params["shard"]
    caches, logits0 = _prefill_caches(cfg, params if prefill_params is None else prefill_params,
                                      inputs_embeds, T + max_new_tokens, plain)
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=device)

    def select(out):
        """A step's output as the loop's carry: with the fused head the raw
        argmax ids of the final norm's output, never logits; else the logits."""
        return head_ids(head_w, out, plain) if fused_head else out

    sel = logits0.argmax(dim=-1) if fused_head else logits0.t()
    done = torch.zeros(B, dtype=torch.bool, device=device)
    step = 0
    # iteration k consumes the previous selection and computes the next one,
    # so only max_new_tokens - 1 layer-stack steps run: the last token is an
    # argmax of the last logits.  With no EOS ids no row can finish, and
    # the loop skips the host sync that the all-done test costs.
    while step < max_new_tokens - 1 and not (eos.numel() and bool(done.all())):
        with span("decode.step"):
            next_tok = torch.where(done, pad_token_id, sel if fused_head else sel.argmax(dim=0))
            tokens[:, step] = next_tok
            done |= torch.isin(next_tok, eos)
            h = llama.scale_embeds(cfg, llama.embed_tokens(cfg, params, next_tok).t()
                                   .to(cfg.dtype))
            sel = select(_decode_step_bl(cfg, params, h.contiguous(), caches, T + step,
                                         head=not fused_head, plain=plain))
        step += 1
    tokens[:, step] = torch.where(done, pad_token_id,
                                  sel if fused_head else sel.argmax(dim=0))
    return tokens


@torch.no_grad()
def sample_generate_bl(
    cfg: LlamaConfig,
    params: dict,
    inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    seed: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    req_ids: Optional[torch.Tensor] = None,
    prefill_params: Optional[dict] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Batch-last sampled decode with request-indexed draws (dmi_tpu's
    sample_generate_bl): row r's token at age n is drawn with
    _req_keys(seed, req_ids[r], max_new_tokens, n), so the tokens are a
    pure function of (seed, request, age) and the continuous-batching
    engine draws the same ones under any slot assignment.  req_ids [B]
    defaults to the rows.  The step is greedy_generate_bl's own
    (_decode_step_bl) with head=True: the full [V, B] logits from
    head_logits_bl (the fused head + argmax is greedy-only).  EOS/pad
    semantics, prefill_params and plain as greedy_generate_bl.  Returns
    [B, max_new_tokens] int64.  A sharded tree samples from the gathered
    logits, the same draws on every model rank."""
    cfg = llama.local_config(cfg, params)
    B, T, _ = inputs_embeds.shape
    device = inputs_embeds.device
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    if max_new_tokens == 0:
        return tokens
    if req_ids is None:
        req_ids = torch.arange(B, device=device)
    req_ids = torch.as_tensor(req_ids, dtype=torch.long, device=device)
    caches, logits = _prefill_caches(cfg, params if prefill_params is None else prefill_params,
                                     inputs_embeds, T + max_new_tokens, plain)
    logits = logits.t()  # [V, B]
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=device)

    def pick(logits, step):
        keys = _req_keys(seed, req_ids, max_new_tokens, step)
        return _sample_pick_bl(logits, keys, temperature, top_k, top_p)

    done = torch.zeros(B, dtype=torch.bool, device=device)
    step = 0
    # as greedy_generate_bl: the last token is drawn from the last logits
    # with no extra layer-stack step
    while step < max_new_tokens - 1 and not (eos.numel() and bool(done.all())):
        next_tok = torch.where(done, pad_token_id, pick(logits, step))
        tokens[:, step] = next_tok
        done |= torch.isin(next_tok, eos)
        h = llama.scale_embeds(cfg, llama.embed_tokens(cfg, params, next_tok).t().to(cfg.dtype))
        # the step skips final_softcap (argmax-invariant for its greedy
        # consumers); sampling draws from the distribution, so it caps here
        # as dmi_tpu does (prefill's logits arrive capped)
        logits = llama.final_softcap(cfg, _decode_step_bl(cfg, params, h.contiguous(), caches,
                                                          T + step, plain=plain))
        step += 1
    tokens[:, step] = torch.where(done, pad_token_id, pick(logits, step))
    return tokens
