"""LoRA-baseline adapters (counterpart of dmi_tpu/models/lora.py; reference
dmi/model/lora.py).

One (A, B) pair per projector linear layer: A ~ N(0, 1) / sqrt(rank), B = 0,
delta = (alpha/rank)·x@A@B (dmi/model/lora.py:6-17).  The forward over the
frozen projector is dmi_tpu_torch.models.projector.module_lora_apply.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch

from dmi_tpu_torch.models.projector import ProjectorSpec


@dataclass(frozen=True)
class LoraSpec:
    rank: int = 32
    alpha: int = 32
    n_proj_layers: int = 2


def init(lora_spec: LoraSpec, proj_spec: ProjectorSpec, generator: torch.Generator,
         dtype=torch.float32, device="cpu") -> List[dict]:
    """Per-layer adapters drawn from `generator` (which must live on
    `device`); layer 0 has in_dim = mm_dim (reference: dmi/model/lora.py:29-35)."""
    std = 1.0 / math.sqrt(lora_spec.rank)
    adapters = []
    for in_dim, out_dim in proj_spec.layer_dims():
        a = torch.randn(in_dim, lora_spec.rank, generator=generator, device=device,
                        dtype=torch.float32) * std
        adapters.append({"a": a.to(dtype),
                         "b": torch.zeros(lora_spec.rank, out_dim, dtype=dtype, device=device)})
    return adapters
