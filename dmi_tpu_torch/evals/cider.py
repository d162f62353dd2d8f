# Copy of dmi_tpu/evals/cider.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""CIDEr-D scorer — the pycocoevalcap algorithm, natively.

Semantics replicated exactly (including the idiosyncrasies the published
numbers depend on):
  * document frequency counted once per image over the union of its refs'
    n-grams; idf = log(N_images) - log(max(1, df))
  * tf = raw n-gram count (CIDEr-D), candidate counts clipped against the
    reference via min(h, r) in the numerator
  * length penalty e^{-(lh-lr)^2 / (2*6^2)} where the "length" accumulator
    counts BIGRAMS (the original implementation increments on n==2 n-grams)
  * per-image score = mean over n of (sum over refs / n_refs) * 10
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

SIGMA = 6.0
N_MAX = 4


def _ngram_counts(tokens: Sequence[str], n_max: int = N_MAX) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def _counts_to_vec(counts, df_log, log_n):
    vec = [defaultdict(float) for _ in range(N_MAX)]
    norm = [0.0] * N_MAX
    length = 0
    for ngram, tf in counts.items():
        df = df_log.get(ngram, 0.0)
        k = len(ngram) - 1
        vec[k][ngram] = tf * (log_n - df)
        norm[k] += vec[k][ngram] ** 2
        if k == 1:  # original implementation counts length from bigrams
            length += tf
    norm = [math.sqrt(x) for x in norm]
    return vec, norm, length


def _sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r):
    delta = float(len_h - len_r)
    out = [0.0] * N_MAX
    for k in range(N_MAX):
        for ngram, h_val in vec_h[k].items():
            # CIDEr-D clipping: min of the two tf-idf values times ref value
            out[k] += min(h_val, vec_r[k].get(ngram, 0.0)) * vec_r[k].get(ngram, 0.0)
        if norm_h[k] != 0 and norm_r[k] != 0:
            out[k] /= norm_h[k] * norm_r[k]
        out[k] *= math.e ** (-(delta**2) / (2 * SIGMA**2))
    return out


def cider_d(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> Tuple[float, List[float]]:
    """candidates: per-image token lists; references: per-image list of
    token lists.  Returns (corpus score, per-image scores)."""
    assert len(candidates) == len(references) and len(candidates) > 0
    n_images = len(candidates)

    ref_counts = [[_ngram_counts(r) for r in refs] for refs in references]
    cand_counts = [_ngram_counts(c) for c in candidates]

    df: Dict[Tuple[str, ...], int] = defaultdict(int)
    for refs in ref_counts:
        seen = set()
        for rc in refs:
            seen.update(rc.keys())
        for ngram in seen:
            df[ngram] += 1
    df_log = {k: math.log(max(1.0, float(v))) for k, v in df.items()}
    log_n = math.log(float(n_images))

    scores = []
    for cand, refs in zip(cand_counts, ref_counts):
        vec_h, norm_h, len_h = _counts_to_vec(cand, df_log, log_n)
        per_n = [0.0] * N_MAX
        for rc in refs:
            vec_r, norm_r, len_r = _counts_to_vec(rc, df_log, log_n)
            s = _sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r)
            for k in range(N_MAX):
                per_n[k] += s[k]
        score = sum(x / len(refs) for x in per_n) / N_MAX * 10.0
        scores.append(score)
    return sum(scores) / n_images, scores
