# Copy of dmi_tpu/evals/rouge.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""COCO ROUGE-L scorer (pycocoevalcap Rouge semantics).

Per image: LCS precision/recall against each reference, take the max of
each over refs, F_beta with beta=1.2; corpus score = mean over images.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

BETA = 1.2


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> Tuple[float, List[float]]:
    scores = []
    for cand, refs in zip(candidates, references):
        prec, rec = [], []
        for ref in refs:
            lcs = _lcs_len(cand, ref)
            prec.append(lcs / len(cand) if cand else 0.0)
            rec.append(lcs / len(ref) if ref else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            f = ((1 + BETA**2) * p * r) / (r + BETA**2 * p)
        else:
            f = 0.0
        scores.append(f)
    return sum(scores) / len(scores), scores
