"""Offline tokenizer fixture with Llama-3 chat semantics, in pure Python.

The real runs use the HF Llama tokenizer (reference:
dmi/utils/model_utils.py:8-15).  Tests and synthetic end-to-end runs use a
tiny byte-level BPE with Llama-3's special tokens and the Llama-3.2 chat
template (generation tags included).  dmi_tpu trains it with the
`tokenizers` package at every call; the port reads the trained vocab and
merges from tok_fixture.json (written once from dmi_tpu's fixture) and
encodes, decodes and renders chats itself, so it needs neither
`tokenizers` nor `transformers` and runs the same on the CPU and the card.
tests/test_torch_tokenizer.py holds it to dmi_tpu's fixture: ids, masks,
rendered chats, assistant masks and decodes.

What `tokenizers` does and this module does alike: added (special) tokens
are split out first; each stretch between them is cut by GPT-2's
pre-tokenizer pattern (a scanner on unicodedata categories, as the card may
lack the `regex` package); each piece's UTF-8 bytes map to GPT-2's
printable characters and merge by rank; decoding maps the characters back
to bytes and replaces invalid UTF-8, with no clean-up of spaces (the
fixture's clean_up_tokenization_spaces is false).
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from dmi_tpu_torch.chat_templates import LLAMA32_CHAT_TEMPLATE
from dmi_tpu_torch.data import chat_render

VOCAB_FILE = Path(__file__).with_name("tok_fixture.json")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    out, extra = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + extra)
            extra += 1
    return out


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


# GPT-2's pattern 's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# as `tokenizers` runs it (Oniguruma: \s is \t-\r, U+0085 and the Z categories)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _space(c: str) -> bool:
    return c in "\t\n\x0b\x0c\r\x85" or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _other(c: str) -> bool:
    return not (_space(c) or _letter(c) or _number(c))


def _piece_end(text: str, i: int) -> int:
    """End of the pre-token that starts at i (the pattern's first match)."""
    n = len(text)
    for c in _CONTRACTIONS:
        if text.startswith(c, i):
            return i + len(c)
    for cls in (_letter, _number, _other):
        k = i + 1 if text[i] == " " and i + 1 < n and cls(text[i + 1]) else i
        if cls(text[k]):
            k += 1
            while k < n and cls(text[k]):
                k += 1
            return k
    k = i + 1
    while k < n and _space(text[k]):
        k += 1
    # \s+(?!\S) leaves the last space before a non-space to the next piece,
    # unless the run is one space long (then \s+ takes it)
    return k if k == n or k - i == 1 else k - 1


def _pre_tokenize(text: str) -> List[Tuple[int, int]]:
    """Character spans of the pre-tokens of text."""
    spans, i = [], 0
    while i < len(text):
        j = _piece_end(text, i)
        spans.append((i, j))
        i = j
    return spans


class ByteLevelBPETokenizer:
    """A byte-level BPE tokenizer read from a `tokenizers` JSON (the subset
    the fixture uses: no normalizer, the ByteLevel pre-tokenizer with GPT-2's
    pattern and no prefix space, BPE without dropout or unknown token, no
    post-processor, the ByteLevel decoder) with a Llama-3 chat template."""

    def __init__(self, spec: dict, chat_template: str):
        tok = spec["tokenizer"]
        model = tok["model"]
        pre = tok["pre_tokenizer"]
        if (tok["normalizer"] is not None or tok["post_processor"] is not None
                or pre.get("type") != "ByteLevel" or pre.get("add_prefix_space")
                or not pre.get("use_regex", True) or tok["decoder"].get("type") != "ByteLevel"
                or model["type"] != "BPE" or model.get("dropout") or model.get("unk_token")
                or model.get("continuing_subword_prefix") or model.get("end_of_word_suffix")
                or model.get("byte_fallback") or model.get("ignore_merges")):
            raise NotImplementedError("not a byte-level BPE of the fixture's kind")
        if spec["clean_up_tokenization_spaces"]:
            raise NotImplementedError("transformers' clean-up of decoded spaces")
        if any(t["lstrip"] or t["rstrip"] or t["single_word"] or t["normalized"]
               for t in tok["added_tokens"]):
            raise NotImplementedError("added tokens that strip, match words or normalize")
        self._vocab: Dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self._ranks = {pair: r for r, pair in enumerate(merges)}
        self._added = {t["content"]: t["id"] for t in tok["added_tokens"]}
        self._special_ids = {t["id"] for t in tok["added_tokens"] if t["special"]}
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        # leftmost-longest, as tokenizers' added-vocabulary matcher
        self._added_re = re.compile("|".join(
            re.escape(t) for t in sorted(self._added, key=len, reverse=True)))
        self._bpe_cache: Dict[str, List[str]] = {}
        self.bos_token = spec["bos_token"]
        self.eos_token = spec["eos_token"]
        self.pad_token = spec["pad_token"]
        self.padding_side = spec["padding_side"]
        self.chat_template = chat_template

    # ------------------------------------------------------------- vocab
    def _id(self, token: str) -> Optional[int]:
        return self._added.get(token, self._vocab.get(token))

    @property
    def bos_token_id(self):
        return self._id(self.bos_token)

    @property
    def eos_token_id(self):
        return self._id(self.eos_token)

    @property
    def pad_token_id(self):
        return self._id(self.pad_token)

    @property
    def vocab_size(self) -> int:
        """The model's vocab without added tokens (transformers' vocab_size)."""
        return len(self._vocab)

    # ------------------------------------------------------------- encode
    def _bpe(self, word: str) -> List[str]:
        """Merge the lowest-ranked adjacent pair (the leftmost on a tie) until
        no pair has a rank."""
        if word in self._bpe_cache:
            return self._bpe_cache[word]
        syms = list(word)
        while len(syms) > 1:
            ranked = [(self._ranks[p], k) for k, p in enumerate(zip(syms, syms[1:]))
                      if p in self._ranks]
            if not ranked:
                break
            _, k = min(ranked)
            syms[k:k + 2] = [syms[k] + syms[k + 1]]
        self._bpe_cache[word] = syms
        return syms

    def _encode_stretch(self, text: str, lo: int, hi: int, ids: list, offsets: list):
        for s, e in _pre_tokenize(text[lo:hi]):
            piece = text[lo + s:lo + e]
            data = piece.encode("utf-8")
            char_of = [c for c, ch in enumerate(piece) for _ in ch.encode("utf-8")]
            p = 0
            for token in self._bpe("".join(_BYTE_CHAR[b] for b in data)):
                ids.append(self._vocab[token])
                start = lo + s + char_of[p]
                p += len(token)
                offsets.append((start, lo + s + char_of[p - 1] + 1))

    def _encode(self, text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
        ids, offsets, pos = [], [], 0
        for m in (self._added_re.finditer(text) if self._added else ()):
            self._encode_stretch(text, pos, m.start(), ids, offsets)
            ids.append(self._added[m.group()])
            offsets.append(m.span())
            pos = m.end()
        self._encode_stretch(text, pos, len(text), ids, offsets)
        return ids, offsets

    def __call__(self, text) -> Dict[str, list]:
        """input_ids, token_type_ids and attention_mask of a string, or of
        each string of a list (the fixture adds no special tokens)."""
        batched = not isinstance(text, str)
        ids = [self._encode(t)[0] for t in (text if batched else [text])]
        out = {"input_ids": ids, "token_type_ids": [[0] * len(r) for r in ids],
               "attention_mask": [[1] * len(r) for r in ids]}
        return out if batched else {k: v[0] for k, v in out.items()}

    # ------------------------------------------------------------- decode
    def decode(self, token_ids, skip_special_tokens: bool = False) -> str:
        """Unknown ids are dropped, as tokenizers drops them."""
        if hasattr(token_ids, "tolist"):
            token_ids = token_ids.tolist()
        if isinstance(token_ids, int):
            token_ids = [token_ids]
        data = bytearray()
        for i in token_ids:
            token = self._id_to_token.get(i)
            if token is None or (skip_special_tokens and i in self._special_ids):
                continue
            if all(c in _CHAR_BYTE for c in token):
                data += bytes(_CHAR_BYTE[c] for c in token)
            else:
                data += token.encode("utf-8")
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, sequences, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(s, skip_special_tokens) for s in sequences]

    # ------------------------------------------------------------- chats
    def apply_chat_template(self, conversation, tokenize: bool = True,
                            add_generation_prompt: bool = False, return_dict: bool = False,
                            return_assistant_tokens_mask: bool = False, **template_kwargs):
        """transformers' apply_chat_template for one conversation (a list of
        messages) or a batch of them: the rendered text, its ids, or (with
        return_dict) its encoding, with assistant_masks marking the tokens
        from the one holding a generation span's first character through
        the one holding its last."""
        if return_dict and not tokenize:
            raise ValueError("return_dict=True is incompatible with tokenize=False")
        batched = isinstance(conversation[0], (list, tuple))
        convs = conversation if batched else [conversation]
        rendered, spans = zip(*(chat_render.render(self.chat_template, c, self.bos_token,
                                                   add_generation_prompt, **template_kwargs)
                                for c in convs))
        if not tokenize:
            return list(rendered) if batched else rendered[0]
        rows = [self._encode(text) for text in rendered]
        out = {"input_ids": [ids for ids, _ in rows],
               "token_type_ids": [[0] * len(ids) for ids, _ in rows],
               "attention_mask": [[1] * len(ids) for ids, _ in rows]}
        if return_assistant_tokens_mask:
            out["assistant_masks"] = [_assistant_mask(len(ids), offsets, s)
                                      for (ids, offsets), s in zip(rows, spans)]
        if not batched:
            out = {k: v[0] for k, v in out.items()}
        return out if return_dict else out["input_ids"]


def _char_to_token(offsets: List[Tuple[int, int]], char: int) -> Optional[int]:
    """The first token whose character span holds `char` (BatchEncoding's
    char_to_token)."""
    return next((t for t, (s, e) in enumerate(offsets) if s <= char < e), None)


def _assistant_mask(n: int, offsets, spans) -> List[int]:
    """transformers' assistant_masks: 1 from the token holding a generation
    span's first character through the one holding its last."""
    mask = [0] * n
    for start, end in spans:
        first, last = _char_to_token(offsets, start), _char_to_token(offsets, end - 1)
        if first is None:
            break
        # transformers reads a last token of 0 as "to the end"
        for t in range(first, last + 1 if last else n):
            mask[t] = 1
    return mask


def build_test_tokenizer(corpus: Optional[Iterable[str]] = None,
                         vocab_size: int = 512) -> ByteLevelBPETokenizer:
    """dmi_tpu's fixture tokenizer (its default corpus and vocab size), read
    from VOCAB_FILE.  Training a BPE on another corpus is not ported."""
    if corpus is not None or vocab_size != 512:
        raise NotImplementedError(
            "the port's fixture tokenizer is the one trained on dmi_tpu's default corpus at "
            "vocab_size 512; training a BPE is not ported")
    with open(VOCAB_FILE, encoding="utf-8") as f:
        spec = json.load(f)
    return ByteLevelBPETokenizer(spec, LLAMA32_CHAT_TEMPLATE)
