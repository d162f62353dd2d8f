"""Corpus BLEU as nltk.translate.bleu_score.corpus_bleu computes it with no
smoothing: clipped n-gram counts summed over the corpus, the reference length
closest to each hypothesis's (the shorter on a tie) for the brevity penalty,
and a precision with no match taken as the smallest positive float (nltk's
method0), so that its BLEU is 0 to within float.  A corpus with no unigram
match scores 0.  tests/test_torch_evals_standalone.py holds it to nltk.
"""

from __future__ import annotations

import math
import sys
from collections import Counter


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def modified_precision(references, hypothesis, n):
    """(clipped matches, max(1, hypothesis n-grams)) of one sentence."""
    counts = _ngrams(hypothesis, n)
    max_counts = {}
    for reference in references:
        ref_counts = _ngrams(reference, n)
        for g in counts:
            max_counts[g] = max(max_counts.get(g, 0), ref_counts[g])
    return (sum(min(c, max_counts[g]) for g, c in counts.items()),
            max(1, sum(counts.values())))


def closest_ref_length(references, hyp_len):
    return min((len(r) for r in references), key=lambda n: (abs(n - hyp_len), n))


def brevity_penalty(ref_len, hyp_len):
    if hyp_len > ref_len:
        return 1
    if hyp_len == 0:
        return 0
    return math.exp(1 - ref_len / hyp_len)


def corpus_bleu(list_of_references, hypotheses, weights=(0.25, 0.25, 0.25, 0.25)):
    assert len(list_of_references) == len(hypotheses), (
        "The number of hypotheses and their reference(s) should be the same")
    order = len(weights)
    num, den = Counter(), Counter()
    hyp_len = ref_len = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for n in range(1, order + 1):
            a, b = modified_precision(references, hypothesis, n)
            num[n] += a
            den[n] += b
        hyp_len += len(hypothesis)
        ref_len += closest_ref_length(references, len(hypothesis))
    bp = brevity_penalty(ref_len, hyp_len)
    if num[1] == 0:
        return 0
    p_n = [num[n] / den[n] if num[n] != 0 else sys.float_info.min
           for n in range(1, order + 1)]
    return bp * math.exp(math.fsum(w * math.log(p) for w, p in zip(weights, p_n) if p > 0))
