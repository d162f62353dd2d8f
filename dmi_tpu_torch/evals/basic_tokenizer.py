"""transformers' BERT BasicTokenizer in pure Python: drop NUL, U+FFFD and
control characters, turn whitespace into spaces, space out CJK ideographs,
NFC-normalise, split on whitespace, lowercase and strip accents (NFD, drop
combining marks), and split every punctuation character off as a token of
its own (transformers/models/bert/tokenization_bert.py, BasicTokenizer with
its defaults).  tests/test_torch_evals_standalone.py holds it to
transformers.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Optional

_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    # every ASCII character that is not a letter, digit or space counts
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch):
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _strip_accents(text):
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _split_on_punc(text):
    out, new_word = [], True
    for ch in text:
        if _is_punctuation(ch):
            out.append(ch)
            new_word = True
        else:
            if new_word:
                out.append("")
            new_word = False
            out[-1] += ch
    return out


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True, never_split: Optional[Iterable[str]] = None,
                 tokenize_chinese_chars: bool = True, strip_accents: Optional[bool] = None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or ())
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents

    def tokenize(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            if ch in "\x00\ufffd" or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(ch):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        tokens = []
        for token in unicodedata.normalize("NFC", "".join(chars)).split():
            if token in self.never_split:
                tokens.append(token)
                continue
            if self.do_lower_case:
                token = token.lower()
                if self.strip_accents is not False:
                    token = _strip_accents(token)
            elif self.strip_accents:
                token = _strip_accents(token)
            tokens.extend(_split_on_punc(token))
        return " ".join(tokens).split()
