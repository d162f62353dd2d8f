# Copy of dmi_tpu/data/inffs.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Infinite Feature Selection (Roffo et al., 2015) — vectorized numpy.

Used to pick the top n_components embedding dimensions when shrinking an
encoder to the shared interface dim (reference: dmi/data/base.py:100-104
calling dmi/data/inffs.py:88-157, unsupervised branch).  Math:

  1. corr_ij  = |spearman(x)| graph term (NaN -> 0)          [n_feat, n_feat]
  2. sigma_ij = pairwise max of per-feature stds, min-subtracted and
     max-normalized (NaN -> 0)
  3. A = alpha*corr + (1-alpha)*sigma
  4. S = (I - rA)^-1 - I  with r = 0.9 / max eigenvalue (geometric path sum)
  5. energy WEIGHT_i = sum_j S_ij; RANKED = features by descending energy

The reference implements steps 2-3 with python double loops; this is the
same computation vectorized.  NOTE: the reference does not take |corr| —
spearman output is used signed, with only NaN/out-of-range zeroed — we
match that exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import stats


def inf_fs(
    x: np.ndarray, alpha: float = 0.2
) -> Tuple[np.ndarray, np.ndarray]:
    """x: [n_samples, n_features] -> (ranked_feature_indices, weights)."""
    corr, _ = stats.spearmanr(x)
    corr = np.asarray(corr, dtype=np.float64)
    bad = ~np.isfinite(corr) | (corr < -1) | (corr > 1)
    corr[bad] = 0.0

    std = np.std(x, ddof=1, axis=0)
    sigma = np.maximum.outer(std, std)
    sigma = sigma - sigma.min()
    m = sigma.max()
    if m > 0:
        sigma = sigma / m
    bad = ~np.isfinite(sigma) | (sigma < -1) | (sigma > 1)
    sigma[bad] = 0.0

    A = alpha * corr + (1 - alpha) * sigma
    r = 0.9 / np.max(np.linalg.eigvals(A).real)
    S = np.linalg.inv(np.eye(A.shape[0]) - r * A) - np.eye(A.shape[0])

    weight = S.sum(axis=1)
    ranked = np.flip(np.argsort(weight), 0)
    return ranked, weight


def select_features(x: np.ndarray, n_components: int, alpha: float = 0.2) -> np.ndarray:
    """Top-n_components feature indices (reference: dmi/data/base.py:100-104)."""
    ranked, _ = inf_fs(x, alpha=alpha)
    return np.asarray(ranked[:n_components])
