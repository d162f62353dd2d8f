# Copy of dmi_tpu/evals/bleu.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""BLEU scorers.

coco_bleu replicates the pycocoevalcap BleuScorer (corpus-level, clipped
n-gram precision with tiny/small epsilons, 'closest' effective reference
length, brevity penalty exp(1 - 1/ratio)).

hf_bleu replicates the HF `evaluate` "bleu" metric (tensorflow-nmt
compute_bleu: geometric mean of modified precisions, zero if any order has
zero matches unless smoothing, closest ref length).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence, Tuple

SMALL = 1e-9
TINY = 1e-15


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def coco_bleu(
    candidates: List[List[str]],
    references: List[List[List[str]]],
    n_max: int = 4,
) -> Tuple[List[float], List[List[float]]]:
    """Returns ([bleu1..bleuN] corpus scores, per-image running scores)."""
    testlen_total = 0
    reflen_total = 0
    guess = [0] * n_max
    correct = [0] * n_max

    for cand, refs in zip(candidates, references):
        testlen = len(cand)
        testlen_total += testlen
        # 'closest' effective reference length (ties -> smaller)
        reflen_total += min((abs(len(r) - testlen), len(r)) for r in refs)[1]
        for n in range(1, n_max + 1):
            cand_counts = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            guess[n - 1] += max(0, testlen - n + 1)
            correct[n - 1] += sum(min(c, max_ref[g]) for g, c in cand_counts.items())

    bleus = []
    running = 1.0
    ratio = (testlen_total + TINY) / (reflen_total + SMALL)
    for n in range(n_max):
        running *= (correct[n] + TINY) / (guess[n] + SMALL)
        score = running ** (1.0 / (n + 1))
        if ratio < 1:
            score *= math.exp(1 - 1 / ratio)
        bleus.append(score)
    return bleus, []


def hf_bleu(
    candidates: List[List[str]],
    references: List[List[List[str]]],
    max_order: int = 4,
    smooth: bool = False,
) -> float:
    """tensorflow-nmt compute_bleu (HF evaluate 'bleu' metric core)."""
    matches_by_order = [0] * max_order
    possible_by_order = [0] * max_order
    reference_length = 0
    translation_length = 0
    for cand, refs in zip(candidates, references):
        reference_length += min(len(r) for r in refs)
        translation_length += len(cand)
        merged_ref = Counter()
        for r in refs:
            for n in range(1, max_order + 1):
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    if c > merged_ref[g]:
                        merged_ref[g] = c
        for n in range(1, max_order + 1):
            overlap = {
                g: min(c, merged_ref[g]) for g, c in _ngrams(cand, n).items()
            }
            matches_by_order[n - 1] += sum(overlap.values())
            possible_by_order[n - 1] += max(0, len(cand) - n + 1)

    precisions = [0.0] * max_order
    for i in range(max_order):
        if smooth:
            precisions[i] = (matches_by_order[i] + 1.0) / (possible_by_order[i] + 1.0)
        elif possible_by_order[i] > 0:
            precisions[i] = matches_by_order[i] / possible_by_order[i]

    if min(precisions) > 0:
        geo_mean = math.exp(sum(math.log(p) for p in precisions) / max_order)
    else:
        geo_mean = 0.0

    ratio = translation_length / reference_length if reference_length else 0.0
    bp = 1.0 if ratio > 1.0 else (math.exp(1 - 1.0 / ratio) if ratio > 0 else 0.0)
    return geo_mean * bp
