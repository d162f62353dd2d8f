"""Small linear-algebra ops (counterpart of dmi_tpu/ops/linalg.py).

  * l2_normalize — row normalization of modality embeddings
    (reference: dmi/utils/model_utils.py:47-62).
  * pad_features — zero-pad pruned embeddings back to the shared interface
    dim (reference: dmi/train_hypernet.py:99-100).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Row-normalize like torch `x / x.norm(dim=1, keepdim=True)` (no eps
    by default — the reference divides by the raw norm)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    if eps:
        norm = norm.clamp_min(eps)
    return x / norm


def pad_features(x: torch.Tensor, target_dim: int) -> torch.Tensor:
    """Zero-pad the last dim up to target_dim (no-op if already there)."""
    cur = x.shape[-1]
    if cur == target_dim:
        return x
    if cur > target_dim:
        raise ValueError(f"cannot pad {cur} -> {target_dim}")
    return F.pad(x, (0, target_dim - cur))
