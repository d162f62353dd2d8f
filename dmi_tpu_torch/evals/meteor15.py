# Copy of dmi_tpu/evals/meteor15.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""METEOR 1.5 scoring model (the reference's coco_meteor semantics).

The reference's COCO harness reports METEOR from the Java METEOR-1.5 jar
inside COCOEvalCap (/root/reference/dmi/utils/eval_utils.py:195-198).  This
module implements that scoring model natively:

  * English parameters alpha=0.85, beta=0.2, gamma=0.6, delta=0.75
  * matcher stages exact (w=1.0), stem (w=0.6, Snowball/Porter2 English),
    synonym (w=0.8), paraphrase (w=0.6) — the synonym stage activates only
    when a synonym source is available (nltk wordnet corpus data, or any
    word->set callable); the paraphrase stage only when a phrase table is
    supplied.  Offline in this image only exact+stem run; the active stages
    are reported so results JSONs can record exactly what was computed.
  * content/function-word split: matched and total words are weighted
    delta (content) vs 1-delta (function) on each side
  * fragmentation penalty gamma * (chunks / avg_matches)^beta
  * CORPUS-level score: the sufficient statistics (weighted matches,
    weighted lengths, chunks, raw matches) are summed over segments and the
    formula is applied once to the totals — NOT a mean of segment scores.
    Per-segment scores pick the best-scoring reference (Java semantics).

Alignment: all possible matches across the active stages are collected,
then the final one-to-one alignment is resolved by the published METEOR
criteria, in order of importance — (1) maximize the number of covered
words across both sentences, (2) minimize the number of chunks,
(3) minimize the sum of absolute distances between match start indices
(Denkowski & Lavie 2014, §2.1).  The resolver is an exact dynamic program
over hypothesis positions (states keyed by used-reference-word sets, with
lexicographic dominance), beam-capped only on pathological repeated-word
inputs — caption-length text is searched exhaustively, and the
equivalence with brute-force subset enumeration is property-tested
(tests/test_meteor15.py).

The function-word list approximates METEOR's English ``function.words``
(top corpus-frequency closed-class words); it is overridable per config.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from dmi_tpu_torch.evals.stem import SnowballStemmer

_STEMMER = SnowballStemmer("english")

# Closed-class English words (articles, prepositions, conjunctions,
# pronouns, auxiliaries/modals, common adverbs of degree) + punctuation —
# an approximation of meteor-1.5's data/function.words (overridable).
DEFAULT_FUNCTION_WORDS = frozenset(
    """
    a an the this that these those some any each every no such
    i you he she it we they me him her us them my your his its our their
    mine yours hers ours theirs myself yourself himself herself itself
    ourselves themselves who whom whose which what
    is are was were be been being am
    do does did done doing
    have has had having
    can could may might must shall should will would
    not n't never
    and or but nor so yet both either neither whether
    if then else because although though while whereas unless until since
    as than that
    of in on at by for with about against between into through during
    before after above below to from up down out off over under again
    further once here there when where why how
    all more most other only own same too very just also
    's 'd 'll 'm 're 've
    . , ; : ! ? ' " ` `` '' ( ) [ ] { } - -- ...
    """.split()
)

STAGE_EXACT, STAGE_STEM, STAGE_SYNONYM, STAGE_PARAPHRASE = range(4)
STAGE_NAMES = ("exact", "stem", "synonym", "paraphrase")


@dataclass(frozen=True)
class Meteor15Config:
    alpha: float = 0.85
    beta: float = 0.2
    gamma: float = 0.6
    delta: float = 0.75
    stage_weights: Tuple[float, float, float, float] = (1.0, 0.6, 0.8, 0.6)
    # word -> collection of synonym words (None disables the stage)
    synonyms: Optional[Callable[[str], frozenset]] = None
    # tuple(words) -> set of tuple(words) (None disables the stage)
    paraphrases: Optional[Mapping[Tuple[str, ...], set]] = None
    function_words: frozenset = DEFAULT_FUNCTION_WORDS

    def active_stages(self) -> List[str]:
        stages = ["exact", "stem"]
        if self.synonyms is not None:
            stages.append("synonym")
        if self.paraphrases is not None:
            stages.append("paraphrase")
        return stages


def wordnet_synonyms() -> Optional[Callable[[str], frozenset]]:
    """Build the synonym matcher from nltk wordnet when its corpus data is
    installed; None otherwise (stage stays off, exactly as documented)."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("dog")  # probe corpus availability
    except Exception:
        return None

    def syns(word: str) -> frozenset:
        out = set()
        for synset in wordnet.synsets(word):
            for lemma in synset.lemma_names():
                out.add(lemma.lower())
        return frozenset(out)

    return syns


def load_paraphrase_table(path: str) -> Dict[Tuple[str, ...], set]:
    """TSV phrase table: ``phrase<TAB>paraphrase`` per line, both
    space-separated lowercase token strings (a flattened export of
    meteor-1.5's paraphrase-en.gz)."""
    table: Dict[Tuple[str, ...], set] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                continue
            a = tuple(parts[0].split())
            b = tuple(parts[1].split())
            table.setdefault(a, set()).add(b)
            table.setdefault(b, set()).add(a)
    return table


def default_config() -> Meteor15Config:
    """Stages activate from what the environment supplies (the data-drop
    procedure in BASELINE.md): the synonym stage from nltk wordnet corpus
    data when present, the paraphrase stage from a TSV table at
    $DMI_METEOR_PARAPHRASES (meteor-1.5's paraphrase-en.gz, gunzipped to
    phrase<TAB>paraphrase lines).  eval_environment() records the active
    stages in every results JSON."""
    import os

    paras = None
    path = os.environ.get("DMI_METEOR_PARAPHRASES")
    if path and os.path.exists(path):
        paras = load_paraphrase_table(path)
    return Meteor15Config(synonyms=wordnet_synonyms(), paraphrases=paras)


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

Match = Tuple[int, int, int, int, int]  # (h_start, h_len, r_start, r_len, stage)


def _word_keys(tokens: Sequence[str], stage: int, cfg: Meteor15Config):
    if stage == STAGE_EXACT:
        return list(tokens)
    if stage == STAGE_STEM:
        return [_STEMMER.stem(t) for t in tokens]
    raise AssertionError(stage)


def candidate_matches(
    h_tok: Sequence[str], r_tok: Sequence[str], cfg: Meteor15Config
) -> List[Match]:
    """ALL possible matches across the active stages (before one-to-one
    resolution).  For a (hyp-span, ref-span) pair matched by several stages
    only the highest-weight stage is kept — the resolution criteria are
    stage-blind, so the stage only affects scoring and the best one is the
    correct attribution."""
    best: Dict[Tuple[int, int, int, int], int] = {}

    def add(i, hl, j, rl, stage):
        key = (i, hl, j, rl)
        prev = best.get(key)
        if prev is None or cfg.stage_weights[stage] > cfg.stage_weights[prev]:
            best[key] = stage

    hk_e = _word_keys(h_tok, STAGE_EXACT, cfg)
    rk_e = _word_keys(r_tok, STAGE_EXACT, cfg)
    hk_s = _word_keys(h_tok, STAGE_STEM, cfg)
    rk_s = _word_keys(r_tok, STAGE_STEM, cfg)
    syn = cfg.synonyms
    for i in range(len(h_tok)):
        for j in range(len(r_tok)):
            if hk_e[i] == rk_e[j]:
                add(i, 1, j, 1, STAGE_EXACT)
            elif hk_s[i] == rk_s[j]:
                add(i, 1, j, 1, STAGE_STEM)
            if syn is not None and hk_e[i] != rk_e[j]:
                a, b = h_tok[i], r_tok[j]
                if b in syn(a) or a in syn(b):
                    add(i, 1, j, 1, STAGE_SYNONYM)
    table = cfg.paraphrases
    if table:
        max_len = max(len(k) for k in table)
        for i in range(len(h_tok)):
            for L in range(1, min(max_len, len(h_tok) - i) + 1):
                targets = table.get(tuple(h_tok[i : i + L]))
                if not targets:
                    continue
                for tgt in targets:
                    Lr = len(tgt)
                    for j in range(len(r_tok) - Lr + 1):
                        if tuple(r_tok[j : j + Lr]) == tgt:
                            add(i, L, j, Lr, STAGE_PARAPHRASE)
    return sorted((i, hl, j, rl, st) for (i, hl, j, rl), st in best.items())


# Resolution value of a partial alignment: lexicographic
# (covered words both sides DESC, chunks ASC, sum |h_start-r_start| ASC).
# States with identical (next hyp index, used ref words, prev match ends)
# have identical future deltas, so per-key lexicographic dominance is exact.
_BEAM = 512  # safety cap; hit only on pathological repeated-word inputs


def align(h_tok: Sequence[str], r_tok: Sequence[str], cfg: Meteor15Config) -> List[Match]:
    """Optimal one-to-one alignment per the METEOR-1.5 criteria (see module
    docstring): exact DP over hypothesis positions, beam-capped at _BEAM
    states only when repeated words explode the used-ref-set space."""
    cands = candidate_matches(h_tok, r_tok, cfg)
    by_start: Dict[int, List[Match]] = {}
    for m in cands:
        by_start.setdefault(m[0], []).append(m)
    # state: (covered, -chunks, -dist) value; key: (ref_used, prev_ends)
    # entry: (covered, chunks, dist, prev_h_end, prev_r_end, ref_used, matches)
    states = [(0, 0, 0, -1, -1, frozenset(), ())]
    for i in range(len(h_tok)):
        nxt = {}

        def push(st):
            cov, ch, di, phe, pre, used, ms = st
            key = (used, phe, pre)
            old = nxt.get(key)
            if old is None or (cov, -ch, -di) > (old[0], -old[1], -old[2]):
                nxt[key] = st

        for st in states:
            cov, ch, di, phe, pre, used, ms = st
            if ms and ms[-1][0] + ms[-1][1] > i:
                push(st)  # inside a phrase match consuming position i
                continue
            push(st)  # leave hyp word i unmatched
            for m in by_start.get(i, ()):
                h0, hl, r0, rl, stage = m
                span = range(r0, r0 + rl)
                if any(r in used for r in span):
                    continue
                contig = h0 == phe and r0 == pre
                push((
                    cov + hl + rl,
                    ch + (0 if contig else 1),
                    di + abs(h0 - r0),
                    h0 + hl,
                    r0 + rl,
                    used | frozenset(span),
                    ms + (m,),
                ))
        states = sorted(
            nxt.values(), key=lambda s: (s[0], -s[1], -s[2]), reverse=True
        )[:_BEAM]
    best = max(states, key=lambda s: (s[0], -s[1], -s[2]))
    return sorted(best[6])


def _count_chunks(matches: List[Match]) -> int:
    chunks = 0
    prev_h_end = prev_r_end = None
    # chunk continues when both sides are contiguous and monotonic
    for h0, hl, r0, rl, _ in sorted(matches):
        if prev_h_end is None or h0 != prev_h_end or r0 != prev_r_end:
            chunks += 1
        prev_h_end, prev_r_end = h0 + hl, r0 + rl
    return chunks


# ---------------------------------------------------------------------------
# Sufficient statistics + scoring
# ---------------------------------------------------------------------------

@dataclass
class Meteor15Stats:
    wm_h: float = 0.0  # stage-and-delta-weighted matched words, hypothesis side
    wm_r: float = 0.0
    wlen_h: float = 0.0  # delta-weighted lengths
    wlen_r: float = 0.0
    m_h: int = 0  # raw matched word counts (for the penalty)
    m_r: int = 0
    chunks: int = 0

    def __iadd__(self, other: "Meteor15Stats") -> "Meteor15Stats":
        self.wm_h += other.wm_h
        self.wm_r += other.wm_r
        self.wlen_h += other.wlen_h
        self.wlen_r += other.wlen_r
        self.m_h += other.m_h
        self.m_r += other.m_r
        self.chunks += other.chunks
        return self


def _weighted_count(tokens: Sequence[str], idxs, cfg: Meteor15Config) -> float:
    total = 0.0
    for i in idxs:
        total += cfg.delta if tokens[i] not in cfg.function_words else 1 - cfg.delta
    return total


def segment_stats(
    h_tok: Sequence[str], r_tok: Sequence[str], cfg: Meteor15Config
) -> Meteor15Stats:
    matches = align(h_tok, r_tok, cfg)
    s = Meteor15Stats()
    s.wlen_h = _weighted_count(h_tok, range(len(h_tok)), cfg)
    s.wlen_r = _weighted_count(r_tok, range(len(r_tok)), cfg)
    for h0, hl, r0, rl, stage in matches:
        w = cfg.stage_weights[stage]
        s.wm_h += w * _weighted_count(h_tok, range(h0, h0 + hl), cfg)
        s.wm_r += w * _weighted_count(r_tok, range(r0, r0 + rl), cfg)
        s.m_h += hl
        s.m_r += rl
    s.chunks = _count_chunks(matches)
    return s


def score_from_stats(s: Meteor15Stats, cfg: Meteor15Config) -> float:
    if s.wlen_h <= 0 or s.wlen_r <= 0 or (s.wm_h <= 0 and s.wm_r <= 0):
        return 0.0
    p = s.wm_h / s.wlen_h
    r = s.wm_r / s.wlen_r
    if p + r == 0:
        return 0.0
    fmean = p * r / (cfg.alpha * p + (1 - cfg.alpha) * r)
    avg_m = (s.m_h + s.m_r) / 2.0
    frag = (s.chunks / avg_m) if avg_m > 0 and s.chunks > 0 else 0.0
    return fmean * (1.0 - cfg.gamma * frag**cfg.beta)


def meteor15_corpus(
    candidates: List[List[str]],
    references: List[List[List[str]]],
    cfg: Optional[Meteor15Config] = None,
) -> Tuple[float, List[float], Dict]:
    """Corpus METEOR-1.5 over tokenized candidates / multi-reference lists.

    Returns (corpus_score, per_segment_scores, meta) where meta records the
    active matcher stages — persisted into results JSONs so later parity
    audits know exactly what ran."""
    if cfg is None:
        cfg = default_config()
    total = Meteor15Stats()
    seg_scores: List[float] = []
    for cand, refs in zip(candidates, references):
        cand = [t.lower() for t in cand]
        best_score, best_stats = 0.0, None
        for ref in refs:
            s = segment_stats(cand, [t.lower() for t in ref], cfg)
            sc = score_from_stats(s, cfg)
            if best_stats is None or sc > best_score:
                best_score, best_stats = sc, s
        seg_scores.append(best_score)
        if best_stats is not None:  # empty reference list: score the segment 0
            total += best_stats
    corpus = score_from_stats(total, cfg) if candidates else 0.0
    meta = {"meteor_impl": "meteor-1.5-native", "meteor_stages": cfg.active_stages()}
    return corpus, seg_scores, meta
