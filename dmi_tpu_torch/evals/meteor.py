# Copy of dmi_tpu/evals/meteor.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""METEOR scorer, data-free.

Implements the nltk meteor_score algorithm (alpha=0.9, beta=3, gamma=0.5)
with the exact-match and Porter-stem alignment stages.  The wordnet-synonym
stage of nltk/METEOR-1.5 requires corpus data this image does not ship;
scores are therefore a slight UNDER-estimate on captions with synonym-only
matches (documented approximation — see evals/__init__ docstring).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from nltk.stem.porter import PorterStemmer

_STEMMER = PorterStemmer()

ALPHA, BETA, GAMMA = 0.9, 3.0, 0.5


def _match_stage(hyp_idx, ref_idx, hyp_tok, ref_tok, key):
    """Greedy left-to-right matching on key(token) like nltk's aligner."""
    matches = []
    used_ref = set()
    for i in hyp_idx:
        hk = key(hyp_tok[i])
        for j in ref_idx:
            if j in used_ref:
                continue
            if hk == key(ref_tok[j]):
                matches.append((i, j))
                used_ref.add(j)
                break
    matched_h = {i for i, _ in matches}
    matched_r = {j for _, j in matches}
    rem_h = [i for i in hyp_idx if i not in matched_h]
    rem_r = [j for j in ref_idx if j not in matched_r]
    return matches, rem_h, rem_r


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    matches = sorted(matches)
    chunks = 0
    prev = None
    for i, j in matches:
        if prev is None or not (i == prev[0] + 1 and j == prev[1] + 1):
            chunks += 1
        prev = (i, j)
    return chunks


def single_meteor(reference: Sequence[str], hypothesis: Sequence[str]) -> float:
    hyp_idx = list(range(len(hypothesis)))
    ref_idx = list(range(len(reference)))
    m1, hyp_idx, ref_idx = _match_stage(hyp_idx, ref_idx, hypothesis, reference, lambda t: t)
    m2, _, _ = _match_stage(hyp_idx, ref_idx, hypothesis, reference, _STEMMER.stem)
    matches = m1 + m2
    m = len(matches)
    if m == 0:
        return 0.0
    precision = m / len(hypothesis)
    recall = m / len(reference)
    fmean = precision * recall / (ALPHA * precision + (1 - ALPHA) * recall)
    chunks = _count_chunks(matches)
    frag = GAMMA * (chunks / m) ** BETA if m > 0 else 0.0
    return fmean * (1 - frag)


def meteor(references: List[Sequence[str]], hypothesis: Sequence[str]) -> float:
    """Max over references (nltk meteor_score semantics)."""
    return max(single_meteor(r, hypothesis) for r in references)


def corpus_meteor(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> Tuple[float, List[float]]:
    scores = [meteor(refs, cand) for cand, refs in zip(candidates, references)]
    return sum(scores) / len(scores), scores
