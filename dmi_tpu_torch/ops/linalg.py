"""Small linear-algebra ops (counterpart of dmi_tpu/ops/linalg.py).

  * random_orthogonal — the isometric augmentation of stage 2, a QR of a
    Gaussian drawn on the generator's device (reference: scipy's ortho_group on
    the host, dmi/train_hypernet.py:56-57).
  * l2_normalize — row normalization of modality embeddings
    (reference: dmi/utils/model_utils.py:47-62).
  * interleave_rows — (mm, text) row interleaving of the conditioning set
    (reference: dmi/train_hypernet.py:76-83).
  * pad_features — zero-pad pruned embeddings back to the shared interface
    dim (reference: dmi/train_hypernet.py:99-100).
  * sinusoidal_positions — the hypernet's positional table
    (reference: dmi/model/hypernet.py:16-23).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmi_tpu_torch.utils import rng


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Row-normalize like torch `x / x.norm(dim=1, keepdim=True)` (no eps
    by default — the reference divides by the raw norm)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    if eps:
        norm = norm.clamp_min(eps)
    return x / norm


def random_orthogonal(dim: int, generator: rng.Generator, dtype=torch.float32) -> torch.Tensor:
    """Haar-distributed random orthogonal [dim, dim] matrix on the
    generator's device: QR of an i.i.d. Gaussian (f32), each column of Q
    multiplied by the sign of R's diagonal entry (1 where it is 0), which
    makes the factorization unique and the distribution Haar."""
    g = rng.normal(generator, (dim, dim))
    q, r = torch.linalg.qr(g)
    d = torch.sign(torch.diagonal(r))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return (q * d[None, :]).to(dtype)


def interleave_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interleave the rows of two [n, d] tensors -> [2n, d] as
    (a0, b0, a1, b1, ...)."""
    if a.shape != b.shape:
        raise ValueError(f"interleave_rows: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return torch.stack((a, b), dim=1).reshape(-1, *a.shape[1:])


def pad_features(x: torch.Tensor, target_dim: int) -> torch.Tensor:
    """Zero-pad the last dim up to target_dim (no-op if already there)."""
    cur = x.shape[-1]
    if cur == target_dim:
        return x
    if cur > target_dim:
        raise ValueError(f"cannot pad {cur} -> {target_dim}")
    return F.pad(x, (0, target_dim - cur))


def sinusoidal_positions(d_model: int, max_len: int, pos_offset: int = 0,
                         device="cpu") -> torch.Tensor:
    """Sinusoidal positional table [max_len, d_model] in f32, sin on the
    even columns and cos on the odd ones."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None] + pos_offset
    # -log(10000) / d_model rounded in f32, as the JAX package computes it
    step = -torch.log(torch.tensor(10000.0, device=device)) / d_model
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device) * step)
    angles = position * div_term[None, :]
    pe = torch.zeros(max_len, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe
