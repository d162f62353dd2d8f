"""Batched KV-cache greedy decode (counterpart of dmi_tpu/models/decode.py,
batch-first loop only).

Replaces HF ``llm.generate(inputs_embeds=..., max_new_tokens=...,
pad_token_id=...)`` (reference: dmi/model/mmmodel.py:61-81,149-169) with
the default generation config, i.e. pure greedy, with HF's semantics:

  * with inputs_embeds, only the newly generated ids are returned
  * per-sequence finish on any EOS id; finished sequences emit pad_token_id
  * the terminating EOS itself is written before the sequence is padded

The caches are [L, B, nkv, S, hd] per K and V, preallocated at prompt
length + max_new_tokens and written in place; each step attends to the
positions written so far.  The loop stops when every row is done.  The
JAX package's batch-last loop (greedy_generate_bl) is token-identical by
contract and was a TPU layout choice; it is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models.llama import LlamaConfig

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

    Returns [B, max_new_tokens] int64 generated ids (pad-filled after a
    row's EOS).  plain=True runs the decode attention's plain twin in place
    of the CUDA kernel (a reference path for comparisons on the card)."""
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
