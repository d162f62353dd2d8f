"""Hugging Face tokenizer directories in Llama-3's layout, read in pure Python.

build_tokenizer (training/model_utils.py) reads a real LM's tokenizer with
this module on the CPU and on the card alike, where neither transformers nor
tokenizers is installed.  It computes what transformers'
PreTrainedTokenizerFast computes over the same tokenizer.json,
tokenizer_config.json and special_tokens_map.json: ids, attention masks,
decodes, chat renders and assistant masks (tests/test_torch_hf_tokenizer.py
holds it to transformers, exactly).

The layout it takes is exactly Llama-3's:

  * no normalizer; the pre-tokenizer Sequence[Split(LLAMA3_PATTERN,
    behavior Isolated, invert false), ByteLevel(add_prefix_space false,
    use_regex false)];
  * a BPE model with ignore_merges, without dropout, unknown token or byte
    fallback; the post-processor Sequence[ByteLevel, TemplateProcessing] or
    TemplateProcessing alone; the ByteLevel decoder;
  * added tokens that neither strip nor normalize, numbered from the
    vocab's end on;
  * tokenizer_class PreTrainedTokenizerFast (LlamaTokenizerFast's
    add_bos_token rewrites the post-processor).

Anything else raises UnsupportedTokenizer, which names the component or
option; build_tokenizer then goes on to transformers' AutoTokenizer.

What tokenizers does, and this module alike (encoding, decoding and chat
templates are tok_fixture.ByteLevelBPETokenizer's):

  * added tokens are split out of the text first, leftmost-longest;
  * the Split pattern runs under Oniguruma's rules, translated to `re`: \\s
    is \\t-\\r, U+0085 and the Z categories; (?i:...) folds case by Unicode's
    simple folding, so that 'ſ (U+017F) is the contraction 's; \\p{L} and
    \\p{N} are unicodedata's categories plus the letters and numbers that
    Unicode 15.1 and 16.0 added (tokenizers' tables are Unicode 16.0's,
    Python 3.12's unicodedata is 15.0.0's);
  * with ignore_merges, a pre-token that the vocab holds whole is one token;
  * tokenizers numbers added tokens from the vocab's end on, whatever ids the
    file gives them; a file whose ids leave a gap is refused;
  * ByteLevel's trim_offsets takes leading and trailing spaces out of each
    token's character span (the first token keeps one leading space under
    add_prefix_space), which moves char_to_token and so the assistant
    masks; TemplateProcessing adds its special tokens with
    add_special_tokens (tokenizer(text) does, apply_chat_template does not);
  * decoding maps the ByteLevel characters back to bytes, then
    clean_up_tokenization_spaces takes the spaces out before punctuation and
    contractions.

write_llama3_tokenizer_dir writes a directory in this layout from the small
BPE in llama3_tok_fixture.json (scripts/torch_llama3_tok_fixture.py trains
it with tokenizers on dmi_tpu's fixture corpus and caption banks), filled
to Llama-3's 128000 vocab ids and 256 special tokens.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from dmi_tpu_torch.data import tok_fixture

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
FIXTURE_FILE = Path(__file__).with_name("llama3_tok_fixture.json")
GOLDEN_FILE = Path(__file__).with_name("llama3_tok_golden.json")
LLAMA3_VOCAB = 128000  # Llama-3's BPE ids; its special tokens follow
_NAMED_SPECIAL = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 4: "<|finetune_right_pad_id|>",
                  6: "<|start_header_id|>", 7: "<|end_header_id|>", 8: "<|eom_id|>",
                  9: "<|eot_id|>", 10: "<|python_tag|>"}

# letters and numbers that Unicode 15.1 and 16.0 assigned, as inclusive
# code point ranges: Oniguruma's tables in tokenizers 0.22 know them,
# unicodedata before Python 3.14 does not (scripts/torch_llama3_tok_fixture.py
# derives them from tokenizers; the test of the pre-tokenizer checks every
# code point)
_ADDED_LETTERS = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
    (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
    (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
    (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_ADDED_NUMBERS = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
                  (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9),
                  (0x1E5F1, 0x1E5FA))


class UnsupportedTokenizer(ValueError):
    """A tokenizer directory outside the layout this module reads; the
    message names the file and the component or option."""


def llama3_special_tokens() -> List[str]:
    """Llama-3.1/3.2's 256 special tokens in id order (128000 on)."""
    names, reserved = [], 0
    for k in range(256):
        if k in _NAMED_SPECIAL:
            names.append(_NAMED_SPECIAL[k])
        else:
            names.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return names


# ---------------------------------------------------------------------------
# The Split pattern under Oniguruma's rules
# ---------------------------------------------------------------------------


def _class(codes) -> str:
    """A regex character class body of the sorted code points `codes`."""
    ranges: List[List[int]] = []
    for c in codes:
        if ranges and c == ranges[-1][1] + 1:
            ranges[-1][1] = c
        else:
            ranges.append([c, c])
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges)


@functools.lru_cache(maxsize=None)
def char_classes() -> Dict[str, List[int]]:
    """The sorted code points of Oniguruma's \\p{L} ("L"), \\p{N} ("N") and
    \\s ("S": \\t-\\r, U+0085 and the Z categories, as tok_fixture._space)."""
    cats = list(map(unicodedata.category, map(chr, range(0x110000))))
    for added, cat in ((_ADDED_LETTERS, "Lo"), (_ADDED_NUMBERS, "No")):
        for a, b in added:
            cats[a:b + 1] = [cat if k == "Cn" else k for k in cats[a:b + 1]]
    classes: Dict[str, List[int]] = {"L": [], "N": [], "Z": []}
    for c, k in enumerate(cats):
        if k[0] in "LNZ":
            classes[k[0]].append(c)
    spaces = sorted({*range(0x9, 0xE), 0x85, *classes.pop("Z")})
    return {**classes, "S": spaces}


@functools.lru_cache(maxsize=None)
def llama3_regex() -> "re.Pattern[str]":
    """LLAMA3_PATTERN as Oniguruma runs it, in Python's `re` (built once a
    process, ~0.4 s)."""
    L, N, S = (_class(codes) for codes in char_classes().values())
    # (?i:'s|...) folds as Unicode's CaseFolding: of the code points, only
    # U+017F (long s) folds to one of these letters besides their own cases
    contractions = "'(?:[sSſ]|[tT]|[rR][eE]|[vV][eE]|[mM]|[lL][lL]|[dD])"
    return re.compile(
        f"{contractions}|[^\\r\\n{L}{N}]?[{L}]+|[{N}]{{1,3}}| ?[^{S}{L}{N}]+[\\r\\n]*"
        f"|[{S}]*[\\r\\n]+|[{S}]+(?![^{S}])|[{S}]+")


def split_isolated(text: str) -> List[Tuple[int, int]]:
    """Character spans of the pieces that Split(LLAMA3_PATTERN, Isolated)
    cuts text into: every match, and every stretch between matches."""
    spans, pos = [], 0
    for m in llama3_regex().finditer(text):
        if m.start() > pos:
            spans.append((pos, m.start()))
        spans.append(m.span())
        pos = m.end()
    if pos < len(text):
        spans.append((pos, len(text)))
    return spans


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


def _want(where: str, what: str, ok: bool) -> None:
    if not ok:
        raise UnsupportedTokenizer(f"{where}: {what}")


def _template_pieces(where: str, pieces) -> List[Tuple[str, str, int]]:
    """TemplateProcessing's pieces as (kind, id, type_id)."""
    out = []
    for piece in pieces:
        _want(where, f"template piece {piece}", isinstance(piece, dict) and len(piece) == 1)
        (kind, body), = piece.items()
        _want(where, f"template piece {kind}", kind in ("SpecialToken", "Sequence"))
        out.append((kind, body["id"], int(body["type_id"])))
    return out


def _token_name(where: str, key: str, value) -> Optional[str]:
    """A special token of tokenizer_config.json or special_tokens_map.json
    (a string, or an AddedToken dict that neither strips nor normalizes)."""
    if value is None or isinstance(value, str):
        return value
    _want(where, f"{key} {value}", isinstance(value, dict) and not any(
        value.get(k) for k in ("lstrip", "rstrip", "single_word", "normalized")))
    return value["content"]


_CONFIG_KEYS = {"added_tokens_decoder", "bos_token", "eos_token", "pad_token", "chat_template",
                "clean_up_tokenization_spaces", "model_input_names", "model_max_length",
                "padding_side", "truncation_side", "tokenizer_class", "split_special_tokens",
                "extra_special_tokens"}
_SPECIAL_KEYS = ("bos_token", "eos_token", "pad_token")


class Llama3Tokenizer(tok_fixture.ByteLevelBPETokenizer):
    """A tokenizer directory in Llama-3's layout, with the surface of
    transformers' PreTrainedTokenizerFast that the port calls: __call__,
    decode, batch_decode, apply_chat_template (through chat_render: the
    Llama-3.1 and 3.2 templates of chat_templates.py), the bos, eos and pad
    tokens and ids, padding_side, model_input_names and vocab_size (the
    model's vocab without added tokens)."""

    def __init__(self, tokenizer: dict, config: dict, special_map: dict):
        self._check_tokenizer(tokenizer)
        model = tokenizer["model"]
        added = tokenizer["added_tokens"]
        # tokenizers' AddedVocabulary numbers the added tokens itself: an id
        # of the model's vocab for a token it holds, else one past the
        # largest so far (the vocab's size for the first)
        ids, special = {}, set()
        for t in added:
            new = model["vocab"].get(t["content"], ids.get(t["content"]))
            if new is None:
                new = max([*ids.values(), len(model["vocab"]) - 1]) + 1
            _want("tokenizer.json", f"added token {t['content']!r} has id {t['id']}, which "
                  f"tokenizers renumbers to {new} (the ids leave a gap after the vocab)",
                  new == t["id"])
            ids[t["content"]] = new
            if t["special"]:
                special.add(new)
        self._read_model(model, ids, special)
        self._check_config(config, added)
        names = {k: _token_name("tokenizer_config.json", k, config.get(k))
                 for k in _SPECIAL_KEYS}
        for key, value in special_map.items():
            _want("special_tokens_map.json", key, key in _SPECIAL_KEYS)
            name = _token_name("special_tokens_map.json", key, value)
            _want("special_tokens_map.json", f"{key} {name!r} differs from "
                  f"tokenizer_config.json's {names[key]!r}", names[key] in (None, name))
            names[key] = name
        for key, name in names.items():
            _want("tokenizer_config.json", f"{key} {name!r} is no special added token",
                  name is None or self._added.get(name) in self._special_ids)
        self.bos_token, self.eos_token, self.pad_token = (names[k] for k in _SPECIAL_KEYS)
        self.padding_side = config.get("padding_side", "right")
        self.model_input_names = list(config.get("model_input_names",
                                                 self.model_input_names))
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))
        self.chat_template = config.get("chat_template")

    # ------------------------------------------------------------ checks
    def _check_tokenizer(self, tok: dict) -> None:
        w = "tokenizer.json"
        for key in ("normalizer", "truncation", "padding"):
            _want(w, f"{key} {tok.get(key)}", tok.get(key) is None)
        pre = tok.get("pre_tokenizer") or {}
        steps = pre.get("pretokenizers", [])
        _want(w, f"pre_tokenizer {pre.get('type')} of "
              f"{[s.get('type') for s in steps]} (Llama-3's is Sequence[Split, ByteLevel])",
              pre.get("type") == "Sequence" and [s.get("type") for s in steps]
              == ["Split", "ByteLevel"])
        split, byte_level = steps
        _want(w, f"Split pattern {split.get('pattern')}",
              split.get("pattern") == {"Regex": LLAMA3_PATTERN})
        _want(w, f"Split behavior {split.get('behavior')}", split.get("behavior") == "Isolated")
        _want(w, "Split invert", split.get("invert") is False)
        _want(w, "ByteLevel pre-tokenizer add_prefix_space",
              byte_level.get("add_prefix_space") is False)
        _want(w, "ByteLevel pre-tokenizer use_regex", byte_level.get("use_regex") is False)

        model = tok.get("model") or {}
        _want(w, f"model {model.get('type')}", model.get("type") == "BPE")
        for key in ("dropout", "unk_token", "continuing_subword_prefix", "end_of_word_suffix"):
            _want(w, f"BPE {key} {model.get(key)}", not model.get(key))
        _want(w, "BPE byte_fallback", not model.get("byte_fallback"))
        _want(w, "BPE without ignore_merges", model.get("ignore_merges") is True)

        post = tok.get("post_processor") or {}
        steps = post.get("processors", []) if post.get("type") == "Sequence" else [post]
        kinds = [s.get("type") for s in steps]
        _want(w, f"post_processor {post.get('type')} of {kinds} (Llama-3's is "
              "Sequence[ByteLevel, TemplateProcessing])",
              kinds in (["ByteLevel", "TemplateProcessing"], ["TemplateProcessing"]))
        self._trim = steps[0].get("trim_offsets", True) if len(steps) == 2 else False
        self._prefix_space = steps[0].get("add_prefix_space", True) if len(steps) == 2 else False
        template = steps[-1]
        self._single = _template_pieces(w, template.get("single", []))
        _want(w, "TemplateProcessing single without one sequence A",
              [p[1] for p in self._single if p[0] == "Sequence"] == ["A"])
        self._template_ids = {}
        for name, special in template.get("special_tokens", {}).items():
            self._template_ids[name] = list(special["ids"])
        _want(w, "TemplateProcessing special token missing", all(
            p[1] in self._template_ids for p in self._single if p[0] == "SpecialToken"))

        _want(w, f"decoder {(tok.get('decoder') or {}).get('type')}",
              (tok.get("decoder") or {}).get("type") == "ByteLevel")
        for t in tok.get("added_tokens", []):
            _want(w, f"added token {t.get('content')!r} that strips, matches words or "
                  "normalizes", not any(t.get(k) for k in ("lstrip", "rstrip", "single_word",
                                                          "normalized")))

    @staticmethod
    def _check_config(config: dict, added) -> None:
        w = "tokenizer_config.json"
        cls = config.get("tokenizer_class")
        _want(w, f"tokenizer_class {cls} (the layout is PreTrainedTokenizerFast's)",
              cls == "PreTrainedTokenizerFast")
        for key in config:
            _want(w, f"option {key}", key in _CONFIG_KEYS)
        _want(w, "split_special_tokens", not config.get("split_special_tokens"))
        _want(w, f"extra_special_tokens {config.get('extra_special_tokens')}",
              not config.get("extra_special_tokens"))
        _want(w, f"padding_side {config.get('padding_side')}",
              config.get("padding_side", "right") in ("right", "left"))
        names = config.get("model_input_names", ["input_ids"])
        _want(w, f"model_input_names {names}", "input_ids" in names and set(names) <= set(
            tok_fixture.ByteLevelBPETokenizer.model_input_names))
        decoder = config.get("added_tokens_decoder")
        if decoder is not None:
            mine = {str(t["id"]): {k: t[k] for k in ("content", "lstrip", "normalized",
                                                     "rstrip", "single_word", "special")}
                    for t in added}
            theirs = {i: {k: v for k, v in t.items() if k in mine.get(i, {})}
                      for i, t in decoder.items()}
            _want(w, "added_tokens_decoder differs from tokenizer.json's added tokens",
                  theirs == mine)

    # ------------------------------------------------------------ encoding
    def _pre_tokenize(self, text: str) -> List[Tuple[int, int]]:
        return split_isolated(text)

    def _post_process(self, ids: list, offsets: list, add_special_tokens: bool):
        """ByteLevel's offset trimming, then TemplateProcessing's single
        template: its special tokens (span (0, 0)) with add_special_tokens,
        and sequence A's type id always."""
        if self._trim:
            offsets = [self._trimmed(i, self._id_to_token[t], span)
                       for i, (t, span) in enumerate(zip(ids, offsets))]
        out_ids, types, spans = [], [], []
        for kind, name, type_id in self._single:
            if kind == "Sequence":
                out_ids += ids
                types += [type_id] * len(ids)
                spans += offsets
            elif add_special_tokens:
                out_ids += self._template_ids[name]
                types += [type_id] * len(self._template_ids[name])
                spans += [(0, 0)] * len(self._template_ids[name])
        return out_ids, types, spans

    def _trimmed(self, i: int, token: str, span: Tuple[int, int]) -> Tuple[int, int]:
        """tokenizers' ByteLevel process_offsets for the token at i."""
        start, end = span
        lead = next((k for k, c in enumerate(token) if c != "Ġ" and not tok_fixture._space(c)),
                    len(token))
        trail = next((k for k, c in enumerate(reversed(token))
                      if c != "Ġ" and not tok_fixture._space(c)), len(token))
        if lead and self._prefix_space and lead == 1 and (i == 0 or start == 0):
            lead = 0
        start = min(start + lead, end)
        if trail and end >= trail:
            end = max(end - trail, start)
        return start, end


def read_tokenizer_dir(directory) -> Llama3Tokenizer:
    """The tokenizer of an HF model directory in Llama-3's layout; raises
    UnsupportedTokenizer for any other (a missing tokenizer.json included)."""
    directory = Path(directory)
    if not (directory / "tokenizer.json").is_file():
        raise UnsupportedTokenizer(f"{directory}: no tokenizer.json")
    files = {}
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        path = directory / name
        files[name] = json.loads(path.read_text(encoding="utf-8")) if path.is_file() else {}
    return Llama3Tokenizer(files["tokenizer.json"], files["tokenizer_config.json"],
                           files["special_tokens_map.json"])


# ---------------------------------------------------------------------------
# The fixture directory
# ---------------------------------------------------------------------------


def _filler(i: int) -> str:
    """Vocab entry i past the trained ones: a digit followed by a letter,
    which no pre-token holds, so that no text encodes to it."""
    return f"{i}filler"


def llama3_tokenizer_files() -> Dict[str, dict]:
    """The three files of the fixture directory: the trained BPE of
    FIXTURE_FILE filled to LLAMA3_VOCAB ids, Llama-3.2's special tokens,
    pre-tokenizer, post-processor (bos added by TemplateProcessing) and
    decoder, and its tokenizer_config.json (bos <|begin_of_text|>, eos
    <|eot_id|>, clean_up_tokenization_spaces, model_max_length 131072)."""
    spec = json.loads(FIXTURE_FILE.read_text(encoding="utf-8"))
    vocab = {t: i for i, t in enumerate(spec["vocab"])}
    vocab.update((_filler(i), i) for i in range(len(vocab), LLAMA3_VOCAB))
    specials = llama3_special_tokens()
    added = [{"id": LLAMA3_VOCAB + k, "content": name, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for k, name in enumerate(specials)]
    bos = specials[0]

    def piece(kind, name, type_id):
        return {kind: {"id": name, "type_id": type_id}}

    tokenizer = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [piece("SpecialToken", bos, 0), piece("Sequence", "A", 0)],
             "pair": [piece("SpecialToken", bos, 0), piece("Sequence", "A", 0),
                      piece("SpecialToken", bos, 1), piece("Sequence", "B", 1)],
             "special_tokens": {bos: {"id": bos, "ids": [LLAMA3_VOCAB], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": spec["merges"]}}
    config = {"added_tokens_decoder": {
        str(t["id"]): {k: t[k] for k in ("content", "lstrip", "normalized", "rstrip",
                                         "single_word", "special")} for t in added},
        "bos_token": bos, "clean_up_tokenization_spaces": True, "eos_token": "<|eot_id|>",
        "model_input_names": ["input_ids", "attention_mask"], "model_max_length": 131072,
        "tokenizer_class": "PreTrainedTokenizerFast"}
    special_map = {"bos_token": {"content": bos, "lstrip": False, "normalized": False,
                                 "rstrip": False, "single_word": False},
                   "eos_token": {"content": "<|eot_id|>", "lstrip": False, "normalized": False,
                                 "rstrip": False, "single_word": False}}
    return {"tokenizer.json": tokenizer, "tokenizer_config.json": config,
            "special_tokens_map.json": special_map}


def write_llama3_tokenizer_dir(directory) -> None:
    """Write the fixture tokenizer's three files into `directory`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name, content in llama3_tokenizer_files().items():
        (directory / name).write_text(json.dumps(content, ensure_ascii=False), encoding="utf-8")


def golden_outputs(tok, texts, chats, date_string) -> dict:
    """What llama3_tok_golden.json records of a tokenizer (transformers' or
    this module's): ids of `texts` with and without special tokens, their
    batch decodes with and without skip_special_tokens, and for both Llama-3
    chat templates, with and without the generation prompt, the render, ids
    and assistant masks of `chats`.  The tokenizer's chat_template is left
    as it was."""
    from dmi_tpu_torch.chat_templates import LLAMA31_CHAT_TEMPLATE, LLAMA32_CHAT_TEMPLATE

    out = {"texts": texts, "chats": chats, "date_string": date_string,
           "ids": tok(texts)["input_ids"],
           "ids_no_special": tok(texts, add_special_tokens=False)["input_ids"]}
    for skip in (False, True):
        out[f"decode_skip_{skip}"] = tok.batch_decode(out["ids"], skip_special_tokens=skip)
    template = tok.chat_template
    try:
        for name, tpl in (("llama31", LLAMA31_CHAT_TEMPLATE), ("llama32", LLAMA32_CHAT_TEMPLATE)):
            tok.chat_template = tpl
            for prompt in (False, True):
                kw = dict(add_generation_prompt=prompt, date_string=date_string)
                enc = tok.apply_chat_template(chats, tokenize=True, return_dict=True,
                                              return_assistant_tokens_mask=True, **kw)
                out[f"{name}_prompt_{prompt}"] = {
                    "rendered": tok.apply_chat_template(chats, tokenize=False, **kw),
                    "input_ids": enc["input_ids"], "assistant_masks": enc["assistant_masks"]}
    finally:
        tok.chat_template = template
    return out
