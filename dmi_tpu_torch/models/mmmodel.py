"""Frozen-LLM soft-prefix captioner glue (counterpart of
dmi_tpu/models/mmmodel.py, generation only): prepend the projected soft
token to the embedded chat prefix and greedy-decode
(reference: dmi/model/mmmodel.py:149-169)."""

from __future__ import annotations

from typing import Optional

import torch

from dmi_tpu_torch.models import decode as dec
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models.llama import LlamaConfig


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
    plain: bool = False,
) -> torch.Tensor:
    """Greedy decode from soft token (+ optional chat prefix) on the
    batch-first loop -> [B, max_new_tokens] ids."""
    embeds = assemble_prompt(cfg, llm_params, soft_tokens, prefix_ids)
    return dec.greedy_generate(cfg, llm_params, embeds, max_new_tokens,
                               pad_token_id, plain=plain)
