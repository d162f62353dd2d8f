"""ROUGE-N, ROUGE-L and ROUGE-Lsum as the rouge_score package computes them.

RougeScorer(types, use_stemmer=False).score(target, prediction) returns a
Score (precision, recall, fmeasure) per type, and score_multi(targets,
prediction) the Score of the target with the best fmeasure, per type
(rouge_score/rouge_scorer.py).  Text goes through rouge_score's default
tokenizer: lowercase, every run outside [a-z0-9] to a space, split;
rougeLsum splits both texts into sentences on newlines and scores the union
LCS of each target sentence.  tests/test_torch_evals_standalone.py holds it
to rouge_score.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Sequence

from dmi_tpu_torch.evals.stem import PorterStemmer

Score = collections.namedtuple("Score", ["precision", "recall", "fmeasure"])

_NON_ALPHANUM = re.compile(r"[^a-z0-9]+")
_SPACES = re.compile(r"\s+")
_VALID = re.compile(r"^[a-z0-9]+$")


def fmeasure(precision, recall):
    return 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0


def tokenize(text: str, stemmer=None) -> List[str]:
    tokens = _SPACES.split(_NON_ALPHANUM.sub(" ", text.lower()))
    if stemmer is not None:
        tokens = [stemmer.stem(t) if len(t) > 3 else t for t in tokens]
    return [t for t in tokens if _VALID.match(t)]


def _ngrams(tokens, n):
    return collections.Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _score_ngrams(target, prediction):
    hits = sum(min(c, prediction[g]) for g, c in target.items())
    precision = hits / max(sum(prediction.values()), 1)
    recall = hits / max(sum(target.values()), 1)
    return Score(precision, recall, fmeasure(precision, recall))


def _lcs_table(ref, can):
    table = [[0] * (len(can) + 1) for _ in range(len(ref) + 1)]
    for i in range(1, len(ref) + 1):
        for j in range(1, len(can) + 1):
            table[i][j] = (table[i - 1][j - 1] + 1 if ref[i - 1] == can[j - 1]
                           else max(table[i - 1][j], table[i][j - 1]))
    return table


def _score_lcs(target, prediction):
    if not target or not prediction:
        return Score(0, 0, 0)
    lcs = _lcs_table(target, prediction)[-1][-1]
    precision, recall = lcs / len(prediction), lcs / len(target)
    return Score(precision, recall, fmeasure(precision, recall))


def _lcs_indices(ref, can):
    """Indices into ref of one LCS of ref and can (rouge_score's backtrack)."""
    t = _lcs_table(ref, can)
    i, j, out = len(ref), len(can), []
    while i > 0 and j > 0:
        if ref[i - 1] == can[j - 1]:
            out.insert(0, i - 1)
            i, j = i - 1, j - 1
        elif t[i][j - 1] > t[i - 1][j]:
            j -= 1
        else:
            i -= 1
    return out


def _summary_level_lcs(ref_sents, can_sents):
    if not ref_sents or not can_sents:
        return Score(0, 0, 0)
    m, n = sum(map(len, ref_sents)), sum(map(len, can_sents))
    if not n or not m:
        return Score(0, 0, 0)
    counts_r, counts_c = collections.Counter(), collections.Counter()
    for s in ref_sents:
        counts_r.update(s)
    for s in can_sents:
        counts_c.update(s)
    hits = 0
    for r in ref_sents:
        union = sorted(set().union(*(_lcs_indices(r, c) for c in can_sents)))
        for tok in (r[i] for i in union):
            if counts_c[tok] > 0 and counts_r[tok] > 0:
                hits += 1
                counts_c[tok] -= 1
                counts_r[tok] -= 1
    recall, precision = hits / m, hits / n
    return Score(precision, recall, fmeasure(precision, recall))


class RougeScorer:
    def __init__(self, rouge_types: Sequence[str], use_stemmer: bool = False):
        self.rouge_types = list(rouge_types)
        self._stemmer = PorterStemmer() if use_stemmer else None

    def _tokenize(self, text):
        return tokenize(text, self._stemmer)

    def score(self, target: str, prediction: str) -> Dict[str, Score]:
        target_tokens = self._tokenize(target)
        prediction_tokens = self._tokenize(prediction)
        result = {}
        for rouge_type in self.rouge_types:
            if rouge_type == "rougeL":
                result[rouge_type] = _score_lcs(target_tokens, prediction_tokens)
            elif rouge_type == "rougeLsum":
                def sents(text):
                    return [self._tokenize(s) for s in text.split("\n") if len(s)]

                result[rouge_type] = _summary_level_lcs(sents(target), sents(prediction))
            elif re.match(r"rouge[0-9]$", rouge_type):
                n = int(rouge_type[5:])
                if n <= 0:
                    raise ValueError(f"rougen requires positive n: {rouge_type}")
                result[rouge_type] = _score_ngrams(_ngrams(target_tokens, n),
                                                   _ngrams(prediction_tokens, n))
            else:
                raise ValueError(f"Invalid rouge type: {rouge_type}")
        return result

    def score_multi(self, targets: Sequence[str], prediction: str) -> Dict[str, Score]:
        scores = [self.score(t, prediction) for t in targets]
        best = {}
        for k in self.rouge_types:
            f = [s[k].fmeasure for s in scores]
            best[k] = scores[f.index(max(f))][k]
        return best
