"""The port's reader of tokenizer directories in Llama-3's layout
(dmi_tpu_torch/data/hf_tokenizer.py, pure Python) against transformers'
PreTrainedTokenizerFast over the same directory: the fixture that
hf_tokenizer.write_llama3_tokenizer_dir writes (a BPE trained here in
Llama-3's layout, 128000 vocab ids, Llama-3.2's 256 special tokens).

Exact equality, no tolerance: ids with and without the special tokens,
attention masks, decodes with and without skip_special_tokens (with the
clean-up of spaces), chat renders, chat ids and assistant masks for both
Llama-3 templates, on the fixture banks, printable ASCII from hypothesis,
random Unicode, the edge strings of Oniguruma's rules and the golden file
that chip_smoke.py holds the reader to on the card.  The character classes
of the Split pattern are held to tokenizers' on every code point.  Every
component and option outside the layout is refused with
UnsupportedTokenizer, which names it.
"""

import copy
import json
import logging
import random
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dmi_tpu.data.fixtures import CAPTION_BANK, PREFIX_BANK
from dmi_tpu.data.tok_fixture import DEFAULT_CORPUS
from dmi_tpu_torch.chat_templates import LLAMA31_CHAT_TEMPLATE, LLAMA32_CHAT_TEMPLATE
from dmi_tpu_torch.config import LMArgs
from dmi_tpu_torch.data import hf_tokenizer
from dmi_tpu_torch.training import model_utils as tmu

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

torch.set_num_threads(1)

BANK = [*DEFAULT_CORPUS, *CAPTION_BANK, *(p for ps in PREFIX_BANK.values() for p in ps)]
TEMPLATES = {"llama31": LLAMA31_CHAT_TEMPLATE, "llama32": LLAMA32_CHAT_TEMPLATE}
DATE = dict(date_string="17 Oct 2026")
ASCII = st.lists(st.characters(min_codepoint=32, max_codepoint=126)
                 | st.sampled_from(["\n", "\r\n", "\t", "<|eot_id|>", "'s", " 're", " .", "  "]),
                 max_size=30).map("".join)
# Oniguruma's rules where Python's `re` would differ, and the pattern's corners
EDGES = [
    "'ſ", " 'ſ", "'ſa", "x'ſa", "'ſt", "'K", "'Ka", "'Sa", "'LL", "'LLama", "I'D", "they'RE",
    "x\x1c\x1fy", "\x1c\x1d\x1e\x1f", "a \x1c b", "a\x85b", "a\x85\x85", "a\xa0b", "a\xa0 b",
    "a b", "x  \n y", "　x", "été", "́x", "a​b", "ﬆ ß K",
    *("7" * n for n in range(1, 8)), " 1234567", "x1234y", "Ⅻ²³½",
    "!!\r\n\r\nx", "?\n", ".\r\n\r\n\r", " ...\n\nnext", "a.\n\n\nb", "\r\n", "  \n x",
    "\t\tx", "a  ", "  a", " ", "   ", "\n", "a \n", "end  \n\n  start",
    "<|eot_id|>", "a<|eot_id|>b", " <|begin_of_text|> ", "<|eot_id", "<|reserved_special_token_9|>",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>",
    " helicopter", "helicopter", " helicopters", " stadium,", "",
]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(the port's reader, transformers' PreTrainedTokenizerFast) over one
    fixture directory."""
    directory = tmp_path_factory.mktemp("llama3-tok")
    hf_tokenizer.write_llama3_tokenizer_dir(directory)
    return (hf_tokenizer.read_tokenizer_dir(directory),
            transformers.PreTrainedTokenizerFast.from_pretrained(str(directory)))


@pytest.fixture(autouse=True)
def _no_template(pair):
    yield
    for tok in pair:
        tok.chat_template = None


def _same_encoding(pair, texts, add_special_tokens=True):
    port, ref = pair
    a = ref(texts, add_special_tokens=add_special_tokens)
    b = port(texts, add_special_tokens=add_special_tokens)
    assert list(b) == list(a) == ["input_ids", "attention_mask"]
    for key in a:
        assert b[key] == a[key], key


def test_special_tokens_sizes_and_options(pair):
    port, ref = pair
    for name in ("bos_token", "eos_token", "pad_token", "bos_token_id", "eos_token_id",
                 "pad_token_id", "vocab_size", "padding_side", "model_input_names",
                 "clean_up_tokenization_spaces"):
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.bos_token_id, port.eos_token_id) == (128000, 128009)
    assert port.vocab_size == 128000 and len(ref) == 128256
    assert port._special_ids == set(range(128000, 128256))
    assert [port.decode([i]) for i in range(128000, 128256)] == \
        hf_tokenizer.llama3_special_tokens() == [ref.decode([i]) for i in range(128000, 128256)]
    port.pad_token = port.eos_token
    ref.pad_token = ref.eos_token
    assert port.pad_token_id == ref.pad_token_id == 128009


def test_fixture_spec_is_the_trained_bpe():
    """llama3_tok_fixture.json is what scripts/torch_llama3_tok_fixture.py
    trains here; its vocab holds words the merges cannot build
    (ignore_merges), and the merges stop well short of the fillers."""
    sys.path.insert(0, str(hf_tokenizer.FIXTURE_FILE.parents[2] / "scripts"))
    import torch_llama3_tok_fixture as script

    spec = json.loads(hf_tokenizer.FIXTURE_FILE.read_text(encoding="utf-8"))
    assert spec == script.train()
    assert 1000 <= len(spec["vocab"]) <= 2000


def test_ignore_merges_takes_a_whole_word(pair):
    """" helicopter" is a vocab entry the merges cannot reach: one token,
    where merging alone gives several."""
    port, ref = pair
    ids = ref(" helicopter", add_special_tokens=False)["input_ids"]
    assert ids == port(" helicopter", add_special_tokens=False)["input_ids"]
    assert len(ids) == 1
    port._ignore_merges = False
    try:
        assert len(port._bpe("Ġhelicopter")) > 1
    finally:
        port._ignore_merges = True


def test_character_classes_match_oniguruma_on_every_code_point():
    """\\p{L}, \\p{N} and \\s of the reader (unicodedata and the Unicode 15.1
    and 16.0 additions) against tokenizers' Oniguruma, code point by code
    point, surrogates aside."""
    codes = [c for c in range(0x110000) if not 0xD800 <= c < 0xE000]
    text = "".join(map(chr, codes))
    mine = hf_tokenizer.char_classes()
    for name, pattern in (("L", r"\p{L}"), ("N", r"\p{N}"), ("S", r"\s")):
        split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), behavior="removed",
                                                invert=False)
        kept = np.zeros(len(codes), bool)
        for _, (s, e) in split.pre_tokenize_str(text):
            kept[s:e] = True
        theirs = np.asarray(codes)[~kept]
        assert theirs.tolist() == mine[name], name


def _split(text):
    return [text[s:e] for s, e in hf_tokenizer.split_isolated(text)]


@pytest.mark.parametrize("text", EDGES, ids=range(len(EDGES)))
def test_edge_strings(pair, text):
    """The pre-tokenizer's pieces and the encodings of each edge string."""
    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(hf_tokenizer.LLAMA3_PATTERN),
                                            behavior="isolated", invert=False)
    pieces = [p for p, _ in split.pre_tokenize_str(text)]
    if "<|" not in text:
        assert _split(text) == pieces
    for add in (True, False):
        _same_encoding(pair, [text], add)
        _same_encoding(pair, text, add)


def test_pre_tokenizer_on_random_text():
    """The Split pattern's alternation over characters of every class, the
    case-folding ones and the spaces Python's re counts and Oniguruma does
    not, against tokenizers' pieces."""
    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(hf_tokenizer.LLAMA3_PATTERN),
                                            behavior="isolated", invert=False)
    rng = random.Random(0)
    pool = list("ab AB\t\n\r\x0b\x0c\x85\x1c\x1d\x1e\x1f\xa0　  'sStTdDlLmMrReEvV"
                ".,!?09_-中éÅ😀Ⅻ²́ſK​ﬆßᲉ\U00013460\U0001e5f1")
    for _ in range(20000):
        text = "".join(rng.choice(pool) for _ in range(rng.randint(0, 24)))
        assert _split(text) == [p for p, _ in split.pre_tokenize_str(text)], repr(text)


@pytest.mark.parametrize("add_special_tokens", [True, False])
def test_encodes_the_banks_batched_and_one_by_one(pair, add_special_tokens):
    _same_encoding(pair, BANK, add_special_tokens)
    for text in BANK:
        _same_encoding(pair, text, add_special_tokens)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.lists(ASCII, min_size=1, max_size=4), st.booleans())
def test_encodes_printable_ascii(pair, texts, add_special_tokens):
    _same_encoding(pair, texts, add_special_tokens)


@pytest.mark.parametrize("add_special_tokens", [True, False])
def test_encodes_random_unicode(pair, add_special_tokens):
    """Letters, numbers, marks, CJK, emoji, every kind of space and special
    tokens; then code points drawn from all of Unicode."""
    rng = random.Random(1)
    pool = list("ab AB\t\n\r\x0b\x0c\x85\x1c\xa0　'sd.,!?09_-中éÅ😀Ⅻ²́ſﬆ") + [
        "'s", "'ll", " 's", "<|eot_id|>", "<|begin_of_text|>", "<|eot_id", " helicopter"]
    texts = ["".join(rng.choice(pool) for _ in range(rng.randint(0, 24))) for _ in range(300)]
    texts += ["".join(chr(rng.choice([rng.randint(1, 0x2FFF), rng.randint(1, 0x10FFFF)]))
                      for _ in range(rng.randint(0, 12))) for _ in range(300)]
    _same_encoding(pair, [t for t in texts if not any(0xD800 <= ord(c) < 0xE000 for c in t)],
                   add_special_tokens)


@pytest.mark.parametrize("skip", [False, True])
def test_decodes(pair, skip):
    """Every id in blocks, ids past the vocab (dropped), special ids, bytes
    that are no valid UTF-8 (replaced) and texts whose spaces the config's
    clean-up takes out ("a dog runs ." decodes as "a dog runs."), as lists,
    numpy rows and tensors."""
    port, ref = pair
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1600, size=(32, 17))
    rows[:, ::5] = rng.integers(128000, 128256 + 8, size=(32, 4))
    spaced = ["a dog runs . it 's here , is n't it ? yes ! they 're ' there ' we 've i 'm",
              " . ? ! , ' ", *BANK, *EDGES]
    ids = [r.tolist() for r in rows] + ref(spaced)["input_ids"] + [
        list(range(k, k + 50)) for k in range(0, 128300, 1999)]
    assert port.batch_decode(ids, skip_special_tokens=skip) == ref.batch_decode(
        ids, skip_special_tokens=skip)
    assert port.batch_decode(rows, skip_special_tokens=skip) == ref.batch_decode(
        rows, skip_special_tokens=skip)
    assert port.batch_decode(torch.as_tensor(rows), skip_special_tokens=skip) == (
        ref.batch_decode(rows, skip_special_tokens=skip))
    assert port.decode(ids[40]) == ref.decode(ids[40]) and port.decode(7) == ref.decode(7)


def _chats(rng, system: bool, n=3):
    chats = []
    for _ in range(n):
        chat = [{"role": "system", "content": rng.choice(BANK) + rng.choice(["", " ", "\n"])}
                ] if system else []
        chat += [{"role": "user", "content": " " + rng.choice(BANK)},
                 {"role": "assistant", "content": rng.choice(BANK) + " "},
                 {"role": "user", "content": rng.choice(BANK)},
                 {"role": "assistant", "content": " " + rng.choice(CAPTION_BANK) + " ."}]
        chats.append(chat)
    return chats


@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("system", [False, True])
@pytest.mark.parametrize("generation_prompt", [False, True])
def test_chat_template_and_assistant_masks(pair, template, system, generation_prompt):
    """Batched chats: the rendered string, input_ids, attention_mask and
    assistant_masks; one chat unbatched as a dict and as plain ids; the
    generation prompt of each prefix, as the trainers and serving build it."""
    port, ref = pair
    port.chat_template = ref.chat_template = TEMPLATES[template]
    chats = _chats(random.Random(f"{template} {system} {generation_prompt}"), system)
    kw = dict(add_generation_prompt=generation_prompt, **DATE)
    assert port.apply_chat_template(chats, tokenize=False, **kw) == ref.apply_chat_template(
        chats, tokenize=False, **kw)
    mask_kw = dict(tokenize=True, return_dict=True, return_assistant_tokens_mask=True, **kw)
    a, b = ref.apply_chat_template(chats, **mask_kw), port.apply_chat_template(chats, **mask_kw)
    assert list(b) == list(a)
    for key in a:
        assert b[key] == a[key], key
    assert all(sum(m) > 0 for m in b["assistant_masks"])
    one, mine = (t.apply_chat_template(chats[0], **mask_kw) for t in (ref, port))
    assert {k: mine[k] for k in one} == dict(one)
    assert port.apply_chat_template(chats[0], tokenize=True, **kw) == ref.apply_chat_template(
        chats[0], tokenize=True, **kw)
    if generation_prompt:
        for prefix in BANK:
            msg = [{"role": "user", "content": prefix}]
            assert port.apply_chat_template(msg, **kw) == ref.apply_chat_template(msg, **kw)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(ASCII, ASCII), min_size=1, max_size=3))
def test_chat_masks_on_printable_ascii(pair, pairs):
    """Assistant content with leading spaces, newlines and special tokens:
    the masks follow char_to_token over the reader's offsets."""
    port, ref = pair
    port.chat_template = ref.chat_template = LLAMA32_CHAT_TEMPLATE
    chats = [[{"role": "user", "content": u}, {"role": "assistant", "content": "  " + a}]
             for u, a in pairs]
    kw = dict(tokenize=True, return_dict=True, return_assistant_tokens_mask=True, **DATE)
    a, b = ref.apply_chat_template(chats, **kw), port.apply_chat_template(chats, **kw)
    assert b["input_ids"] == a["input_ids"]
    assert b["assistant_masks"] == a["assistant_masks"]


def test_chat_masks_on_random_unicode(pair):
    port, ref = pair
    port.chat_template = ref.chat_template = LLAMA31_CHAT_TEMPLATE
    rng = random.Random(2)
    pool = list("ab \t\n\r\x85\xa0　'sS.,!?09中é😀́ſ") + ["<|eot_id|>", " helicopter"]
    chats = [[{"role": "user", "content": "".join(rng.choice(pool) for _ in range(12))},
              {"role": "assistant", "content": "".join(rng.choice(pool) for _ in range(20))}]
             for _ in range(200)]
    kw = dict(tokenize=True, return_dict=True, return_assistant_tokens_mask=True, **DATE)
    a, b = ref.apply_chat_template(chats, **kw), port.apply_chat_template(chats, **kw)
    assert b["input_ids"] == a["input_ids"]
    assert b["assistant_masks"] == a["assistant_masks"]


def test_golden_file_is_transformers_output_and_the_reader_gives_it(pair, tmp_path):
    """llama3_tok_golden.json is transformers' output over the fixture (as
    scripts/torch_llama3_tok_fixture.py writes it), and the reader gives it
    exactly (the check chip_smoke.py makes on the card)."""
    sys.path.insert(0, str(hf_tokenizer.FIXTURE_FILE.parents[2] / "scripts"))
    import torch_llama3_tok_fixture as script

    gold = json.loads(hf_tokenizer.GOLDEN_FILE.read_text(encoding="utf-8"))
    hf_tokenizer.write_llama3_tokenizer_dir(tmp_path)
    assert gold == script.golden(tmp_path)
    port, _ = pair
    got = hf_tokenizer.golden_outputs(port, gold["texts"], gold["chats"], gold["date_string"])
    assert sorted(got) == sorted(gold)
    for key in gold:
        assert got[key] == gold[key], key


def test_trim_offsets_moves_the_masks_as_transformers_does(tmp_path):
    """With the post-processor's ByteLevel trim_offsets on (Llama-3's file
    has it off), leading and trailing spaces leave the tokens' spans: the
    masks and char_to_token follow transformers', and TemplateProcessing
    alone (no ByteLevel step) reads too."""
    files = hf_tokenizer.llama3_tokenizer_files()
    trimmed = copy.deepcopy(files)
    trimmed["tokenizer.json"]["post_processor"]["processors"][0]["trim_offsets"] = True
    bare = copy.deepcopy(files)
    bare["tokenizer.json"]["post_processor"] = files["tokenizer.json"]["post_processor"][
        "processors"][1]
    rng = random.Random(3)
    words = [" a", "  ", " \n", "dog", " ", ".", "'s", "\n\n", " helicopter", "  x "]
    chats = [[{"role": "user", "content": "hi"},
              {"role": "assistant", "content": "".join(rng.choice(words) for _ in range(9))}]
             for _ in range(100)]
    texts = [" a", "  lead", "trail  ", "a  b", *("".join(c[1]["content"]) for c in chats)]
    for label, variant in (("trimmed", trimmed), ("bare", bare)):
        directory = tmp_path / label
        directory.mkdir()
        for name, content in variant.items():
            (directory / name).write_text(json.dumps(content), encoding="utf-8")
        port = hf_tokenizer.read_tokenizer_dir(directory)
        ref = transformers.PreTrainedTokenizerFast.from_pretrained(str(directory))
        _same_encoding((port, ref), texts)
        port.chat_template = ref.chat_template = LLAMA32_CHAT_TEMPLATE
        kw = dict(tokenize=True, return_dict=True, return_assistant_tokens_mask=True, **DATE)
        a, b = ref.apply_chat_template(chats, **kw), port.apply_chat_template(chats, **kw)
        assert b["assistant_masks"] == a["assistant_masks"], label
        enc = ref(texts, add_special_tokens=False, return_offsets_mapping=True)
        _, offsets = port._encodings(texts, add_special_tokens=False)
        assert [[tuple(o) for o in row] for row in enc["offset_mapping"]] == offsets, label


def test_added_ids_that_follow_the_vocab_are_read(tmp_path):
    """A vocab without the fillers and special ids right after it: the ids
    tokenizers keeps, so the reader takes the file and agrees."""
    files = hf_tokenizer.llama3_tokenizer_files()
    vocab = {t: i for t, i in files["tokenizer.json"]["model"]["vocab"].items() if i < 1506}
    files["tokenizer.json"]["model"]["vocab"] = vocab
    for t in files["tokenizer.json"]["added_tokens"]:
        t["id"] -= 128000 - len(vocab)
    files["tokenizer.json"]["post_processor"]["processors"][1]["special_tokens"][
        "<|begin_of_text|>"]["ids"] = [len(vocab)]
    files["tokenizer_config.json"]["added_tokens_decoder"] = {
        str(t["id"]): {k: v for k, v in t.items() if k != "id"}
        for t in files["tokenizer.json"]["added_tokens"]}
    for name, content in files.items():
        (tmp_path / name).write_text(json.dumps(content), encoding="utf-8")
    port = hf_tokenizer.read_tokenizer_dir(tmp_path)
    ref = transformers.PreTrainedTokenizerFast.from_pretrained(str(tmp_path))
    assert port.bos_token_id == ref.bos_token_id == len(vocab)
    _same_encoding((port, ref), BANK + EDGES)


def _set(path, value):
    def change(files):
        node = files
        for key in path[:-1]:
            node = node[key]
        if value is _DELETE:
            del node[path[-1]]
        else:
            node[path[-1]] = value
    return change


_DELETE = object()
_TOK, _CFG, _MAP = "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"
_PRE = (_TOK, "pre_tokenizer", "pretokenizers")
_POST = (_TOK, "post_processor", "processors")
_BPE = (_TOK, "model")


def _gap(files):
    """The added ids of a small vocab as a file may give them: 128000 on,
    which tokenizers would renumber."""
    model = files[_TOK]["model"]
    model["vocab"] = {t: i for t, i in model["vocab"].items() if i < 263}
    model["merges"] = [m for m in model["merges"]
                       if all(p in model["vocab"] for p in (*m.split(" "), m.replace(" ", "")))]


def _gpt2(files):
    files[_TOK]["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False,
                                    "trim_offsets": True, "use_regex": True}


REFUSALS = {
    "normalizer": (_set((_TOK, "normalizer"), {"type": "NFC"}), "normalizer"),
    "truncation": (_set((_TOK, "truncation"), {"max_length": 8}), "truncation"),
    "padding": (_set((_TOK, "padding"), {"strategy": "BatchLongest"}), "padding"),
    "gpt2-pre-tokenizer": (_gpt2, "pre_tokenizer ByteLevel"),
    "split-pattern": (_set((*_PRE, 0, "pattern"), {"Regex": r"\s+|\S+"}), "Split pattern"),
    "split-string": (_set((*_PRE, 0, "pattern"), {"String": " "}), "Split pattern"),
    "split-behavior": (_set((*_PRE, 0, "behavior"), "Removed"), "Split behavior"),
    "split-invert": (_set((*_PRE, 0, "invert"), True), "Split invert"),
    "byte-level-prefix": (_set((*_PRE, 1, "add_prefix_space"), True), "add_prefix_space"),
    "byte-level-regex": (_set((*_PRE, 1, "use_regex"), True), "use_regex"),
    "model": (_set((*_BPE, "type"), "WordPiece"), "model WordPiece"),
    "dropout": (_set((*_BPE, "dropout"), 0.1), "BPE dropout"),
    "unk": (_set((*_BPE, "unk_token"), "!"), "BPE unk_token"),
    "byte-fallback": (_set((*_BPE, "byte_fallback"), True), "byte_fallback"),
    "suffix": (_set((*_BPE, "end_of_word_suffix"), "</w>"), "end_of_word_suffix"),
    "no-ignore-merges": (_set((*_BPE, "ignore_merges"), False), "ignore_merges"),
    "no-post-processor": (_set((_TOK, "post_processor"), None), "post_processor"),
    "roberta-post-processor": (_set((_TOK, "post_processor"), {
        "type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0]}), "post_processor"),
    "template-without-a": (_set((*_POST, 1, "single"), [
        {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}}]), "sequence A"),
    "decoder": (_set((_TOK, "decoder"), {"type": "Metaspace"}), "decoder Metaspace"),
    "added-lstrip": (_set((_TOK, "added_tokens", 3, "lstrip"), True), "strips"),
    "added-normalized": (_set((_TOK, "added_tokens", 3, "normalized"), True), "normalizes"),
    "added-id-gap": (_gap, "leave a gap"),
    "llama-tokenizer-class": (_set((_CFG, "tokenizer_class"), "LlamaTokenizerFast"),
                              "tokenizer_class"),
    "no-tokenizer-class": (_set((_CFG, "tokenizer_class"), _DELETE), "tokenizer_class"),
    "add-bos-option": (_set((_CFG, "add_bos_token"), True), "option add_bos_token"),
    "split-special-tokens": (_set((_CFG, "split_special_tokens"), True),
                             "split_special_tokens"),
    "added-tokens-decoder": (_set((_CFG, "added_tokens_decoder", "128009", "content"), "x"),
                             "added_tokens_decoder"),
    "bos-not-special": (lambda f: (_set((_CFG, "bos_token"), "the")(f),
                                   _set((_MAP, "bos_token"), _DELETE)(f)),
                        "no special added token"),
    "map-extra-key": (_set((_MAP, "additional_special_tokens"), ["<|eom_id|>"]),
                      "additional_special_tokens"),
    "map-disagrees": (_set((_MAP, "eos_token", "content"), "<|end_of_text|>"), "differs"),
    "map-strips": (_set((_MAP, "eos_token", "lstrip"), True), "eos_token"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuses_every_other_component_and_option(tmp_path, case):
    """Each change outside Llama-3's layout raises UnsupportedTokenizer
    naming the file and the component or option."""
    change, words = REFUSALS[case]
    files = copy.deepcopy(hf_tokenizer.llama3_tokenizer_files())
    change(files)
    for name, content in files.items():
        (tmp_path / name).write_text(json.dumps(content), encoding="utf-8")
    with pytest.raises(hf_tokenizer.UnsupportedTokenizer, match=words):
        hf_tokenizer.read_tokenizer_dir(tmp_path)


def test_refuses_a_directory_without_tokenizer_json(tmp_path):
    with pytest.raises(hf_tokenizer.UnsupportedTokenizer, match="no tokenizer.json"):
        hf_tokenizer.read_tokenizer_dir(tmp_path)


def test_build_tokenizer_routes_by_the_files(tmp_path, monkeypatch, caplog):
    """A directory in Llama-3's layout is read by the reader (pad = eos, the
    chat template kept); a refused one goes to AutoTokenizer with the
    refusal logged; any other error is not caught."""
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    hf_tokenizer.write_llama3_tokenizer_dir(tmp_path / "llama3")
    tok = tmu.build_tokenizer(LMArgs(lm_name_or_path=str(tmp_path / "llama3")))
    assert isinstance(tok, hf_tokenizer.Llama3Tokenizer)
    assert tok.pad_token == tok.eos_token == "<|eot_id|>" and tok.pad_token_id == 128009

    files = hf_tokenizer.llama3_tokenizer_files()
    files[_CFG]["tokenizer_class"] = "LlamaTokenizerFast"
    (tmp_path / "other").mkdir()
    for name, content in files.items():
        (tmp_path / "other" / name).write_text(json.dumps(content), encoding="utf-8")
    with caplog.at_level(logging.WARNING, logger="dmi_tpu_torch"):
        other = tmu.build_tokenizer(LMArgs(lm_name_or_path=str(tmp_path / "other")))
    assert isinstance(other, transformers.PreTrainedTokenizerBase)
    assert "tokenizer_class LlamaTokenizerFast" in caplog.text
    assert other.pad_token == "<|eot_id|>"

    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "tokenizer.json").write_text("{", encoding="utf-8")
    with pytest.raises(json.JSONDecodeError):
        tmu.build_tokenizer(LMArgs(lm_name_or_path=str(tmp_path / "broken")))
