"""Frozen-LLM soft-prefix captioner glue (counterpart of
dmi_tpu/models/mmmodel.py): project the modality embedding to ONE soft
token; for the loss, prepend it to the text embeddings, extend the
attention mask with 1 and the labels with -100, and run the frozen LM
(reference: dmi/model/mmmodel.py:112-147); for generation, prepend it to
the embedded chat prefix and greedy-decode (reference:
dmi/model/mmmodel.py:149-169) or sample (caption_sample), on the plain
loops or through speculative decoding (caption_*_speculative)."""

from __future__ import annotations

from typing import Optional

import torch

from dmi_tpu_torch.models import decode as dec
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models.llama import LlamaConfig
from dmi_tpu_torch.utils.profiling import span


def assemble_inputs(
    cfg: LlamaConfig,
    llm_params: dict,
    soft_tokens: torch.Tensor,     # [B, lm_dim]
    input_ids: torch.Tensor,       # [B, T]
    attention_mask: torch.Tensor,  # [B, T]
    labels: torch.Tensor,          # [B, T]
):
    """Prepend the soft token (reference: dmi/model/mmmodel.py:112-136)."""
    B = soft_tokens.shape[0]
    text_embeds = llama.embed_tokens(cfg, llm_params, input_ids)
    inputs_embeds = torch.cat([soft_tokens[:, None, :].to(text_embeds.dtype), text_embeds],
                              dim=1)
    attention_mask = torch.cat(
        [attention_mask.new_ones((B, 1)), attention_mask], dim=1)
    labels = torch.cat([labels.new_full((B, 1), -100), labels], dim=1)
    return inputs_embeds, attention_mask, labels


def caption_loss(
    cfg: LlamaConfig,
    llm_params: dict,
    soft_tokens: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    labels: torch.Tensor,
    mask_padding: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """loss = LM(inputs_embeds = soft ⊕ text, labels = -100 ⊕ labels).

    Reference quirk, kept by default as dmi_tpu keeps it (mmmodel.py:56-68):
    the reference builds the extended attention mask but never passes it
    to the LLM, so the loss runs full causal attention over the pad
    columns, whose positions carry loss.  mask_padding=True passes it (keys
    masked, queries not).  plain=True runs the attention's plain twin in
    place of the CUDA kernels.

    On a sharded tree (parallel.shard_llm_params; the rows are this data
    rank's) it returns the pair (summed NLL, count of valid labels) of these
    rows, from vocab-sharded logits: the trainer divides the sum by the
    count summed over the data ranks (the global token mean, exact for
    uneven counts).  Span train.forward."""
    with span("train.forward"):
        inputs_embeds, attention_mask, labels = assemble_inputs(
            cfg, llm_params, soft_tokens, input_ids, attention_mask, labels
        )
        shard = llm_params.get("shard")
        logits = llama.forward(cfg, llm_params, inputs_embeds,
                               attention_mask if mask_padding else None, plain=plain,
                               vocab_local=shard is not None)
        if shard is not None:
            return llama.causal_lm_nll(logits, labels, shard=shard)
        return llama.causal_lm_loss(logits, labels)


def caption_loss_grouped(
    cfg: LlamaConfig,
    llm_params: dict,
    soft_tokens: torch.Tensor,     # [G*B, lm_dim]
    input_ids: torch.Tensor,       # [G*B, T]
    attention_mask: torch.Tensor,
    labels: torch.Tensor,
    groups: int,
    mask_padding: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """caption_loss of G stacked micro-batches in one LLM forward -> [G]
    per-group losses (dmi_tpu's mmmodel.caption_loss_grouped), for the
    coalesced stage-2 step.  Groups padded to a common T extend labels with
    -100 and the mask with 0: causal attention keeps the extension invisible
    to real positions, so each group's loss equals its own caption_loss up
    to summation order.  On a sharded tree: the pair ([G] summed NLLs, [G]
    counts) of this data rank's rows, as caption_loss."""
    inputs_embeds, attention_mask, labels = assemble_inputs(
        cfg, llm_params, soft_tokens, input_ids, attention_mask, labels
    )
    shard = llm_params.get("shard")
    logits = llama.forward(cfg, llm_params, inputs_embeds,
                           attention_mask if mask_padding else None, plain=plain,
                           vocab_local=shard is not None)
    if shard is not None:
        return llama.causal_lm_nll(logits, labels, groups, shard)
    return llama.causal_lm_loss_grouped(logits, labels, groups)


def assemble_prompt(
    cfg: LlamaConfig,
    llm_params: dict,
    soft_tokens: torch.Tensor,             # [B, lm_dim]
    prefix_ids: Optional[torch.Tensor],    # [B, P] chat-template prompt, or None
) -> torch.Tensor:
    """soft token ⊕ embedded chat prefix -> [B, 1 + P, H]."""
    embeds = soft_tokens[:, None, :]
    if prefix_ids is not None:
        prefix_embeds = llama.embed_tokens(cfg, llm_params, prefix_ids)
        embeds = torch.cat([embeds.to(prefix_embeds.dtype), prefix_embeds], dim=1)
    return embeds


def caption_generate(
    cfg: LlamaConfig,
    llm_params: dict,
    soft_tokens: torch.Tensor,
    prefix_ids: Optional[torch.Tensor],
    max_new_tokens: int,
    pad_token_id: int,
    prefill_params: Optional[dict] = None,
    batch_first: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Greedy decode from soft token (+ optional chat prefix) ->
    [B, max_new_tokens] ids (reference: dmi/model/mmmodel.py:149-169).

    Runs the batch-last loop (dec.greedy_generate_bl), token-identical to
    dec.greedy_generate; batch_first=True pins the batch-first loop.
    prefill_params: unquantized weights for the prompt pass (and the
    prompt's embedding rows) when llm_params are W8A8- or W4A8-quantized
    (see dec.greedy_generate_bl).  The batch-first loop has no such split:
    it runs wholly on llm_params, so it stays a coherent parity oracle."""
    if batch_first:
        embeds = assemble_prompt(cfg, llm_params, soft_tokens, prefix_ids)
        return dec.greedy_generate(cfg, llm_params, embeds, max_new_tokens,
                                   pad_token_id, plain=plain)
    embeds = assemble_prompt(cfg, llm_params if prefill_params is None else prefill_params,
                             soft_tokens, prefix_ids)
    return dec.greedy_generate_bl(cfg, llm_params, embeds, max_new_tokens, pad_token_id,
                                  prefill_params=prefill_params, plain=plain)


def caption_sample(
    cfg: LlamaConfig,
    llm_params: dict,
    soft_tokens: torch.Tensor,
    prefix_ids: Optional[torch.Tensor],
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
    """Sampled caption decode with request-indexed draws (dmi_tpu's
    caption_sample; the reference decodes greedily only): the tokens of a
    request id are a pure function of (seed, request, age), so the
    continuous-batching engine reproduces them under any slot assignment
    (dec.sample_generate_bl).  prefill_params and plain as caption_generate."""
    embeds = assemble_prompt(cfg, llm_params if prefill_params is None else prefill_params,
                             soft_tokens, prefix_ids)
    return dec.sample_generate_bl(cfg, llm_params, embeds, max_new_tokens, pad_token_id, seed,
                                  temperature, top_k, top_p, req_ids,
                                  prefill_params=prefill_params, plain=plain)


def caption_generate_speculative(
    cfg: LlamaConfig,
    llm_params: dict,
    draft_cfg: LlamaConfig,
    draft_params: dict,
    soft_tokens: torch.Tensor,
    prefix_ids: Optional[torch.Tensor],
    max_new_tokens: int,
    pad_token_id: int,
    k: int = 4,
    prefill_params: Optional[dict] = None,
    draft_prefill_params: Optional[dict] = None,
    draft_prompt_embeds: Optional[torch.Tensor] = None,
    share_prefill: bool = False,
    plain: bool = False,
):
    """Greedy caption decode through the draft-verify loop
    (speculative.speculative_generate_bl): token-identical to
    caption_generate for any draft.  The self-draft (a W4A8 copy of the
    target, serve.Captioner(speculative=k)) shares the target's embedding
    space, so the assembled prompt is its prompt too; another draft passes
    draft_prompt_embeds (and shares the vocab ids).  Returns (tokens,
    rounds): dmi_tpu's returns the tokens alone; the rounds are what
    acceptance buys and what the serving layer reports."""
    from dmi_tpu_torch.models.speculative import speculative_generate_bl

    embeds = assemble_prompt(cfg, llm_params if prefill_params is None else prefill_params,
                             soft_tokens, prefix_ids)
    return speculative_generate_bl(
        cfg, llm_params, draft_cfg, draft_params, embeds,
        embeds if draft_prompt_embeds is None else draft_prompt_embeds, max_new_tokens,
        pad_token_id, k=k, prefill_params=prefill_params,
        draft_prefill_params=draft_prefill_params, share_prefill=share_prefill, plain=plain)


def caption_sample_speculative(
    cfg: LlamaConfig,
    llm_params: dict,
    draft_cfg: LlamaConfig,
    draft_params: dict,
    soft_tokens: torch.Tensor,
    prefix_ids: Optional[torch.Tensor],
    max_new_tokens: int,
    pad_token_id: int,
    seed: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    req_ids: Optional[torch.Tensor] = None,
    k: int = 4,
    prefill_params: Optional[dict] = None,
    draft_prefill_params: Optional[dict] = None,
    draft_prompt_embeds: Optional[torch.Tensor] = None,
    share_prefill: bool = False,
    plain: bool = False,
):
    """Sampled caption decode through the speculative loop
    (speculative.speculative_sample_bl): caption_sample's request-indexed
    law for any draft, bit-identical to caption_sample when draft ==
    target.  Returns (tokens, rounds), as caption_generate_speculative."""
    from dmi_tpu_torch.models.speculative import speculative_sample_bl

    embeds = assemble_prompt(cfg, llm_params if prefill_params is None else prefill_params,
                             soft_tokens, prefix_ids)
    return speculative_sample_bl(
        cfg, llm_params, draft_cfg, draft_params, embeds,
        embeds if draft_prompt_embeds is None else draft_prompt_embeds, max_new_tokens,
        pad_token_id, seed, temperature, top_k, top_p, req_ids, k=k,
        prefill_params=prefill_params, draft_prefill_params=draft_prefill_params,
        share_prefill=share_prefill, plain=plain)
