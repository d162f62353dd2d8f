"""Batched KV-cache greedy decode (counterpart of dmi_tpu/models/decode.py):
the batch-first loop and the batch-last loop, which is the serving default.

Replaces HF ``llm.generate(inputs_embeds=..., max_new_tokens=...,
pad_token_id=...)`` (reference: dmi/model/mmmodel.py:61-81,149-169) with
the default generation config, i.e. pure greedy, with HF's semantics:

  * with inputs_embeds, only the newly generated ids are returned
  * per-sequence finish on any EOS id; finished sequences emit pad_token_id
  * the terminating EOS itself is written before the sequence is padded

The caches are [L, B, nkv, S, hd] per K and V, preallocated at prompt
length + max_new_tokens and written in place; each step attends to the
positions written so far.  The loops stop when every row is done.

The batch-last loop (greedy_generate_bl) keeps a decode step's activations
as [features, B], the form its kernels take: the whole gated MLP in one
weight stream (ops/cuda/decode_mlp), the packed W4A8 and the W8A8 matmuls
(ops/cuda/w4_matmul) and the tied head fused with the argmax
(ops/cuda/head_argmax).  It serves unquantized trees and the three
quantized ones of models/quant.py.  Prefill stays batch-first and the K/V
caches stay as prefill wrote them: the step transposes only its own
[nh*hd, B] tensors and attends through the decode-attention kernel
(ops/cuda/decode_attn).  dmi_tpu's merged [L, 2, nkv, S, hd, B] cache, its
windowed phase schedule and its two-token unroll are TPU lane-layout and
while_loop compile choices with no counterpart here: the Python loop
attends to the pos + 1 written positions, which is token-exact.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models.llama import LlamaConfig
from dmi_tpu_torch.models.quant import int_matmul, quantize_act, unpack_w4
from dmi_tpu_torch.ops.cuda.decode_attn import _decode_attn_plain, fused_decode_attention
from dmi_tpu_torch.ops.cuda.decode_mlp import _decode_mlp_plain, fused_decode_mlp_bl
from dmi_tpu_torch.ops.cuda.head_argmax import _head_argmax_plain, head_argmax, head_logits_bl
from dmi_tpu_torch.ops.cuda.w4_matmul import _w4_mm_plain, _w8_mm_plain, w4_mm_bl, w8_mm_bl

NEG_INF = torch.finfo(torch.float32).min


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _run_layers(cfg, params, x, cos, sin, bias, caches, cache_index: int,
                last_only: bool = False, plain: bool = False):
    """Every layer in turn over x, writing the caches in place; returns the
    head's logits (of the last position only when last_only: prefill needs
    just the next-token logits, and [B, T, V] is its largest tensor)."""
    k_cache, v_cache = caches
    for i, lw in enumerate(params["layers"]):
        x = llama._block(cfg, x, lw, cos, sin, bias, (k_cache[i], v_cache[i]),
                         cache_index, plain=plain)
    if last_only:
        x = x[:, -1:, :]
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return llama._head_matmul(x, params, cfg)


def prefill(cfg, params, inputs_embeds, caches, plain: bool = False):
    """Run the uniform-length prompt, filling caches at positions [0, T);
    returns the next-token logits [B, V]."""
    T = inputs_embeds.shape[1]
    device = inputs_embeds.device
    positions = torch.arange(T, device=device)
    cos, sin = llama.rope_tables(cfg, positions)
    causal = positions[None, :] <= positions[:, None]  # [T, T]
    bias = torch.where(causal, 0.0, NEG_INF)
    x = llama.scale_embeds(cfg, inputs_embeds.to(cfg.dtype))
    logits = _run_layers(cfg, params, x, cos, sin, bias, caches, 0,
                         last_only=True, plain=plain)
    return logits[:, -1, :]


def decode_step(cfg, params, token_embeds, caches, pos: int, plain: bool = False):
    """One token step writing absolute position `pos`; returns logits [B, V]."""
    device = token_embeds.device
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=device))
    # all valid: each layer attends to a view of the pos + 1 written positions
    bias = torch.zeros((1, pos + 1), dtype=torch.float32, device=device)
    x = llama.scale_embeds(cfg, token_embeds.to(cfg.dtype))
    logits = _run_layers(cfg, params, x, cos, sin, bias, caches, pos, plain=plain)
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
    comparisons on the card)."""
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


def _rms_norm_bl(x, scale, eps):
    """rms_norm over the leading (feature) axis of a batch-last [H, B]."""
    xf = x.float()
    var = (xf * xf).mean(dim=0, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()[:, None]).to(x.dtype)


def _mm_bl(w, h, plain: bool = False):
    """Batch-last matmul: w [in, out] (or a quantized dict of
    models/quant.py), h [in, B] -> [out, B]; equals (h^T @ w)^T.

    "q8" and per-channel "qp" weights quantize the activations per token and
    run the int8 kernels of ops/cuda/w4_matmul (their twins when `plain`);
    grouped "qp" weights ("s4g") unpack and run G partial products weighted
    by their groups' scales, which dmi_tpu also computes outside its kernel;
    "q" weights are widened to h's dtype per call (eager torch materialises
    the widened copy that XLA fuses into its dot)."""
    if not isinstance(w, dict):
        return w.t() @ h
    if "q8" in w:
        hq, a = quantize_act(h, axis=0)  # a [1, B]
        return (_w8_mm_plain if plain else w8_mm_bl)(w, hq, a, h.dtype)
    if "qp" in w:
        hq, a = quantize_act(h, axis=0)
        if "s4g" in w:
            q8 = unpack_w4(w["qp"])
            s4g = w["s4g"]  # [G, out]
            G, K = s4g.shape[0], q8.shape[0]
            qg = q8.reshape(G, K // G, q8.shape[1])
            hg = hq.reshape(G, K // G, hq.shape[1])
            acc = int_matmul(qg.transpose(1, 2), hg)  # [G, out, B]
            return ((acc * s4g[:, :, None]).sum(dim=0) * a).to(h.dtype)
        return (_w4_mm_plain if plain else w4_mm_bl)(w, hq, a, h.dtype)
    if "q" in w:
        return (w["q"].to(h.dtype).t() @ h) * w["s"].to(h.dtype).reshape(-1, 1)
    raise ValueError(f"unknown quantized dict keys {sorted(w)}")


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


def _decode_step_bl(cfg, params, h, caches, pos: int, head: bool = True, plain: bool = False):
    """One batch-last token step (the llama-3.x branch of dmi_tpu's
    _decode_step_bl).  h [H, B]; caches ([L, B, nkv, S, hd] x 2) as prefill
    wrote them, written IN PLACE at absolute position `pos`.  Returns the
    logits [V, B], or with head=False the final norm's output [H, B] for the
    fused head + argmax.

    On CUDA tensors an unquantized fused w_gu runs the decode-MLP kernel,
    quantized weights the int8 kernels (_mm_bl) and attention the
    decode-attention kernel on the step's transposed q/k/v; plain=True runs
    every kernel's plain twin instead."""
    k_cache, v_cache = caches
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    g = nh // nkv
    B = h.shape[1]
    cos, sin = llama.rope_tables(cfg, torch.tensor(pos, device=h.device))  # [hd] each
    # all valid: each layer attends to a view of the pos + 1 written positions
    bias = torch.zeros(pos + 1, dtype=torch.float32, device=h.device)
    scale = llama.attn_score_scale(cfg)
    attend = _decode_attn_plain if plain else fused_decode_attention
    mlp = _decode_mlp_plain if plain else fused_decode_mlp_bl

    def mm(w, x):
        return _mm_bl(w, x, plain=plain)

    x = h
    for li, lw in enumerate(params["layers"]):
        hn = _rms_norm_bl(x, lw["ln_attn"], cfg.rms_norm_eps)
        if "w_qkv" in lw:
            q, k, v = torch.split(mm(lw["w_qkv"], hn), [nh * hd, nkv * hd, nkv * hd], dim=0)
        else:
            q, k, v = mm(lw["wq"], hn), mm(lw["wk"], hn), mm(lw["wv"], hn)
        q = _rope_bl(q.reshape(nkv, g, hd, B), cos, sin)
        k = _rope_bl(k.reshape(nkv, hd, B), cos, sin)
        v = v.reshape(nkv, hd, B)
        # only the step's own tensors change layout: [.., hd, B] -> [B, .., hd]
        k_cache[li][:, :, pos] = k.permute(2, 0, 1)
        v_cache[li][:, :, pos] = v.permute(2, 0, 1)
        attn = attend(q.reshape(nh, hd, B).permute(2, 0, 1)[:, :, None, :].contiguous(),
                      k_cache[li][:, :, :pos + 1], v_cache[li][:, :, :pos + 1], bias,
                      scale, cfg.attn_logit_softcap)
        attn = attn.reshape(B, nh * hd).t().contiguous()
        x = x + mm(lw["wo"], attn)
        hn = _rms_norm_bl(x, lw["ln_mlp"], cfg.rms_norm_eps)
        if "w_gu" in lw and not isinstance(lw["w_gu"], dict):
            # the whole MLP in one weight stream
            mlp_out = mlp(lw["w_gu"], lw["w_down"], hn, "silu")
        elif "w_gu" in lw:  # quantized layouts go through _mm_bl
            gate, up = mm(lw["w_gu"], hn).chunk(2, dim=0)
            mlp_out = mm(lw["w_down"], llama.mlp_activation(cfg, gate) * up)
        else:
            gate = llama.mlp_activation(cfg, mm(lw["w_gate"], hn))
            mlp_out = mm(lw["w_down"], gate * mm(lw["w_up"], hn))
        x = x + mlp_out
    x = _rms_norm_bl(x, params["final_norm"], cfg.rms_norm_eps)
    if not head:
        return x
    return head_logits_bl(params["embed"], x)


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
    loop never forms [V, B] logits; None resolves to cfg.dtype == bfloat16
    (the kernel bakes in bf16 score rounding to match the logits path, so
    an f32 model takes logits + argmax).  plain=True runs every kernel's
    plain twin (a reference path for comparisons on the card)."""
    B, T, _ = inputs_embeds.shape
    device = inputs_embeds.device
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    if max_new_tokens == 0:
        return tokens
    if fused_head is None:
        fused_head = cfg.dtype == torch.bfloat16
    caches = init_cache(cfg, B, T + max_new_tokens, device)
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=device)
    logits0 = prefill(cfg, params if prefill_params is None else prefill_params,
                      inputs_embeds, caches, plain=plain)

    def select(out):
        """A step's output as the loop's carry: with the fused head the raw
        argmax ids of the final norm's output, never logits; else the logits."""
        if not fused_head:
            return out
        return _head_argmax_plain(params["embed"], out) if plain else head_argmax(params, out)

    sel = logits0.argmax(dim=-1) if fused_head else logits0.t()
    done = torch.zeros(B, dtype=torch.bool, device=device)
    step = 0
    # iteration k consumes the previous selection and computes the next one,
    # so only max_new_tokens - 1 layer-stack steps run: the last token is an
    # argmax of the last logits.  With no EOS ids no row can finish, and
    # the loop skips the host sync that the all-done test costs.
    while step < max_new_tokens - 1 and not (eos.numel() and bool(done.all())):
        next_tok = torch.where(done, pad_token_id, sel if fused_head else sel.argmax(dim=0))
        tokens[:, step] = next_tok
        done |= torch.isin(next_tok, eos)
        h = llama.scale_embeds(cfg, llama.embed_tokens(cfg, params, next_tok).t().to(cfg.dtype))
        sel = select(_decode_step_bl(cfg, params, h.contiguous(), caches, T + step,
                                     head=not fused_head, plain=plain))
        step += 1
    tokens[:, step] = torch.where(done, pad_token_id,
                                  sel if fused_head else sel.argmax(dim=0))
    return tokens
