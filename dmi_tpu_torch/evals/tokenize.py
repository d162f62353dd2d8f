# Copy of dmi_tpu/evals/tokenize.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Caption tokenizers.

ptb_tokenize is a clean-room model of what the COCO-caption harness
produces: Stanford CoreNLP PTBTokenizer (ptb3Escaping defaults,
`-preserveLines -lowerCase`) piped through pycocoevalcap's PUNCTUATIONS
filter (reference execution: dmi/utils/eval_utils.py:195-198 via
COCOEvalCap).  Modeled PTB3 behaviors (each pinned by
tests/test_ptb_tokenizer.py against outputs transcribed from the
published PTB3/CoreNLP tokenization spec):

  * contraction splitting (ca n't, it 's, they 're, i 'll, ...)
  * assimilation splitting (cannot -> can not, gonna -> gon na, ...)
  * 'tis/'twas -> 't is / 't was
  * word-internal apostrophes and hyphens kept (o'brien, well-known,
    5-year-old); trailing possessive apostrophe split off
  * numbers keep internal [.,:/] (3.14, 10,000, 3:30, 3/4); $ and %
    split from the number
  * acronyms keep their periods (u.s., e.g.)
  * quote/dash/ellipsis normalization: unicode and ascii double quotes
    -> `` / '', curly apostrophes -> ', em/en dashes -> --, ... kept as
    one token
  * brackets normalize to -lrb-/-rrb-/-lsb-/-rsb-/-lcb-/-rcb-

The PUNCTUATIONS filter replicates pycocoevalcap's EXECUTED semantics,
including its quirk: the filter list spells bracket tokens UPPERCASE
(-LRB-) but runs on the already-lowercased Java output, so bracket
tokens are never removed — "(two dogs)" scores as "-lrb- two dogs
-rrb-".  Quotes/periods/commas/etc. are removed as intended.

Documented divergences from the Java tool (evals/environment.py carries
the impl tag; these cannot shift scores unless a generated caption and a
ground truth disagree on exactly these forms):
  * no americanization (colour stays colour)
  * no legacy \\/ and \\* escaping (3/4 stays 3/4, not 3\\/4)
  * single-letter initials ("J. Smith") split their period

tokenizer_13a mirrors HF `evaluate`'s default BLEU tokenizer (mteval-13a).
"""

from __future__ import annotations

import re
from typing import List

# pycocoevalcap's PUNCTUATIONS list, applied to lowercased tokens exactly
# like the wrapper does (hence the -LRB- entries are dead — see module
# docstring)
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# --- pre-pass normalizations (ptb3Escaping) --------------------------------

_UNICODE_MAP = {
    "“": '"', "”": '"', "„": '"', "«": '"', "»": '"',
    "‘": "'", "’": "'", "‚": "'",
    "–": "--", "—": "--",
    "…": "...",
}

_BRACKETS = {
    "(": " -LRB- ", ")": " -RRB- ",
    "[": " -LSB- ", "]": " -RSB- ",
    "{": " -LCB- ", "}": " -RCB- ",
}

# PTB3 assimilation splits (tokenizer.sed / CoreNLP PTBLexer)
_ASSIM = [
    (re.compile(r"(?i)\b(can)(not)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(gon)(na)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(wan)(na)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(got)(ta)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(lem)(me)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(gim)(me)\b"), r"\1 \2"),
    (re.compile(r"(?i)'(t)(is|was)\b"), r"'\1 \2"),
]

_CONTRACTIONS = re.compile(r"(?i)\b(\w+)(n't)\b")
_APOS = re.compile(r"(?i)(\w)('s|'re|'ve|'ll|'d|'m)\b")
_POSSESSIVE_FINAL = re.compile(r"(?i)([a-z0-9])'(?=\s|$)")
_OPEN_QUOTE = re.compile(r'(^|[\s\(\[\{])"')

_TOKEN = re.compile(
    r"(?i)"
    r"-[lr][rcs]b-"                      # normalized brackets
    r"|``|''"                            # normalized double quotes
    r"|n't|'(?:s|re|ve|ll|d|m|t)\b"      # split contraction halves
    r"|(?:[a-z]\.){2,}"                  # acronyms keep periods (u.s.)
    r"|\d+(?:[.,:/]\d+)*(?![^\W_]|-)"    # numbers: 3.14 / 10,000 / 3:30 / 3/4
    r"|[^\W_]+(?:[-'][^\W_]+)*"          # words (unicode) incl. -/' ; 3rd
    r"|\.\.\.|--"                        # multi-char punctuation
    r"|[^\w\s]",                         # any other single punctuation
    re.UNICODE,
)


def ptb_tokenize(caption: str) -> List[str]:
    s = caption
    for u, a in _UNICODE_MAP.items():
        s = s.replace(u, a)
    s = s.replace("\n", " ")
    for b, r in _BRACKETS.items():
        s = s.replace(b, r)
    s = _OPEN_QUOTE.sub(r"\1``", s)
    s = s.replace('"', "''")
    for pat, rep in _ASSIM:
        s = pat.sub(rep, s)
    s = _CONTRACTIONS.sub(r"\1 \2", s)
    s = _APOS.sub(r"\1 \2", s)
    s = _POSSESSIVE_FINAL.sub(r"\1 '", s)
    toks = _TOKEN.findall(s)
    # the wrapper's executed order: lowercase (Java -lowerCase), THEN the
    # PUNCTUATIONS filter — which is why -lrb- style tokens survive it
    return [t for t in (t.lower() for t in toks) if t not in PUNCTUATIONS]


def ptb_join(caption: str) -> str:
    return " ".join(ptb_tokenize(caption))


_13A_NONASCII = re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])")


def tokenizer_13a(line: str) -> List[str]:
    """mteval-v13a tokenization (HF evaluate bleu default)."""
    line = line.strip()
    line = re.sub(r"<skipped>", "", line)
    line = re.sub(r"-\n", "", line)
    line = re.sub(r"\n", " ", line)
    if "&" in line:
        line = line.replace("&quot;", '"').replace("&amp;", "&")
        line = line.replace("&lt;", "<").replace("&gt;", ">")
    line = f" {line} "
    line = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", line)
    line = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", line)
    line = re.sub(r"([\.,])([^0-9])", r" \1 \2", line)
    line = re.sub(r"([0-9])(-)", r"\1 \2 ", line)
    return line.split()
