"""The port's own fixture tokenizer (dmi_tpu_torch/data/tok_fixture.py, pure
Python over tok_fixture.json) against dmi_tpu's, which trains the same BPE
with `tokenizers` and wraps it in transformers' PreTrainedTokenizerFast.
Exact equality of ids, attention masks, rendered chats, assistant masks,
decodes and special ids, on every string of dmi_tpu's corpus and of the
fixture data's banks, on printable-ASCII text from hypothesis, and on
random Unicode text (the pre-tokenizer's character classes).
"""

import json
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dmi_tpu.data.fixtures import CAPTION_BANK, PREFIX_BANK
from dmi_tpu.data.tok_fixture import DEFAULT_CORPUS
from dmi_tpu.data.tok_fixture import build_test_tokenizer as reference_tokenizer
from dmi_tpu_torch.chat_templates import LLAMA31_CHAT_TEMPLATE, LLAMA32_CHAT_TEMPLATE
from dmi_tpu_torch.data import tok_fixture

torch.set_num_threads(1)

REF = reference_tokenizer()
PORT = tok_fixture.build_test_tokenizer()
BANK = [*DEFAULT_CORPUS, *CAPTION_BANK, *(p for ps in PREFIX_BANK.values() for p in ps)]
TEMPLATES = {"llama31": LLAMA31_CHAT_TEMPLATE, "llama32": LLAMA32_CHAT_TEMPLATE}
# printable ASCII, with newlines, tabs, a special token and contractions mixed in
ASCII = st.lists(st.characters(min_codepoint=32, max_codepoint=126)
                 | st.sampled_from(["\n", "\t", "<|eot_id|>", "'s", " 're"]),
                 max_size=30).map("".join)


def _fixture_json() -> dict:
    """What tok_fixture.json holds: dmi_tpu's trained tokenizer."""
    return {"bos_token": REF.bos_token, "eos_token": REF.eos_token, "pad_token": REF.pad_token,
            "padding_side": REF.padding_side,
            "clean_up_tokenization_spaces": REF.clean_up_tokenization_spaces,
            "tokenizer": json.loads(REF.backend_tokenizer.to_str())}


def test_vocab_file_is_dmi_tpus_trained_tokenizer():
    """tok_fixture.json is dmi_tpu's fixture as trained here (write it anew
    with json.dumps(_fixture_json()) if dmi_tpu's corpus changes)."""
    assert json.loads(tok_fixture.VOCAB_FILE.read_text(encoding="utf-8")) == _fixture_json()


def test_special_ids_and_sizes():
    for name in ("bos_token_id", "eos_token_id", "pad_token_id", "vocab_size", "padding_side",
                 "bos_token", "eos_token", "pad_token"):
        assert getattr(PORT, name) == getattr(REF, name), name
    assert PORT.chat_template == REF.chat_template == LLAMA32_CHAT_TEMPLATE


def test_build_refuses_other_corpora():
    with pytest.raises(NotImplementedError):
        tok_fixture.build_test_tokenizer(corpus=["a b"])
    with pytest.raises(NotImplementedError):
        tok_fixture.build_test_tokenizer(vocab_size=300)


def _same_encoding(texts):
    a, b = REF(texts), PORT(texts)
    assert b["input_ids"] == a["input_ids"]
    assert b["attention_mask"] == a["attention_mask"]
    assert b["token_type_ids"] == a["token_type_ids"]


def test_encodes_the_banks_batched_and_one_by_one():
    _same_encoding(BANK)
    for text in BANK:
        _same_encoding(text)
        assert PORT(text)["input_ids"] == REF.encode(text, add_special_tokens=False)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.lists(ASCII, min_size=1, max_size=4))
def test_encodes_printable_ascii(texts):
    _same_encoding(texts)


def test_encodes_random_unicode():
    """Letters, numbers, marks, CJK, emoji and every kind of space."""
    rng = random.Random(0)
    pool = list("ab AB\t\n\r\x0b\x0c\x85\x1c\xa0 　'sd.,!?09_-中éÅ😀Ⅻ²́") + [
        "'s", "'ll", " 's", "<|eot_id|>", "<|begin_of_text|>", "<|eot_id"]
    texts = ["".join(rng.choice(pool) for _ in range(rng.randint(0, 24))) for _ in range(300)]
    texts += ["".join(chr(rng.randint(1, 0x2FFF)) for _ in range(rng.randint(0, 12)))
              for _ in range(300)]
    _same_encoding([t for t in texts if not any(0xD800 <= ord(c) < 0xE000 for c in t)])


@pytest.mark.parametrize("skip", [False, True])
def test_decodes(skip):
    """Every id, out-of-vocab ids (dropped), special ids and byte pieces that
    are no valid UTF-8 (replaced), as lists, numpy rows and tensors."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(REF) + 12, size=(64, 17))
    ids = [r.tolist() for r in rows] + [REF(t)["input_ids"] for t in BANK]
    assert PORT.batch_decode(ids, skip_special_tokens=skip) == REF.batch_decode(
        ids, skip_special_tokens=skip)
    assert PORT.batch_decode(rows, skip_special_tokens=skip) == REF.batch_decode(
        rows, skip_special_tokens=skip)
    assert PORT.batch_decode(torch.as_tensor(rows), skip_special_tokens=skip) == (
        REF.batch_decode(rows, skip_special_tokens=skip))
    assert PORT.decode(list(range(len(REF))), skip_special_tokens=skip) == REF.decode(
        list(range(len(REF))), skip_special_tokens=skip)


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(ASCII)
def test_decode_inverts_encode(text):
    ids = PORT(text)["input_ids"]
    assert PORT.decode(ids) == REF.decode(ids) == text


def _chats(rng, system: bool, assistant: bool, n=3):
    chats = []
    for _ in range(n):
        chat = [{"role": "system", "content": rng.choice(BANK) + rng.choice(["", " ", "\n"])}
                ] if system else []
        chat.append({"role": "user", "content": " " + rng.choice(BANK)})
        if assistant:
            chat.append({"role": "assistant", "content": rng.choice(BANK) + " "})
            chat.append({"role": "user", "content": rng.choice(BANK)})
            chat.append({"role": "assistant", "content": rng.choice(CAPTION_BANK)})
        chats.append(chat)
    return chats


def _with_template(template):
    REF.chat_template = PORT.chat_template = TEMPLATES[template]


@pytest.fixture(autouse=True)
def _reset_templates():
    yield
    REF.chat_template = PORT.chat_template = LLAMA32_CHAT_TEMPLATE


@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("system", [False, True])
@pytest.mark.parametrize("generation_prompt", [False, True])
def test_chat_template_and_assistant_masks(template, system, generation_prompt):
    """Batched chats: the rendered string, input_ids, attention_mask and
    assistant_masks; one chat unbatched as a dict and as plain ids."""
    _with_template(template)
    chats = _chats(random.Random(f"{template} {system} {generation_prompt}"), system,
                   assistant=True)
    kw = dict(add_generation_prompt=generation_prompt)
    assert PORT.apply_chat_template(chats, tokenize=False, **kw) == REF.apply_chat_template(
        chats, tokenize=False, **kw)
    a = REF.apply_chat_template(chats, tokenize=True, return_dict=True,
                                return_assistant_tokens_mask=True, **kw)
    b = PORT.apply_chat_template(chats, tokenize=True, return_dict=True,
                                 return_assistant_tokens_mask=True, **kw)
    for key in ("input_ids", "attention_mask", "assistant_masks"):
        assert b[key] == a[key], key
    assert all(sum(m) > 0 for m in b["assistant_masks"])
    one = REF.apply_chat_template(chats[0], tokenize=True, return_dict=True,
                                  return_assistant_tokens_mask=True, **kw)
    mine = PORT.apply_chat_template(chats[0], tokenize=True, return_dict=True,
                                    return_assistant_tokens_mask=True, **kw)
    assert mine["input_ids"] == one["input_ids"]
    assert mine["assistant_masks"] == one["assistant_masks"]
    assert PORT.apply_chat_template(chats[0], tokenize=True, **kw) == REF.apply_chat_template(
        chats[0], tokenize=True, **kw)


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_generation_prompt_of_each_prefix(template):
    """The prompts the trainers and serving build (prefix_prompt_ids)."""
    _with_template(template)
    for prefix in BANK:
        msg = [{"role": "user", "content": prefix}]
        assert PORT.apply_chat_template(msg, tokenize=True, add_generation_prompt=True) == (
            REF.apply_chat_template(msg, tokenize=True, add_generation_prompt=True))


def test_fixed_date_string_and_refused_template():
    _with_template("llama32")
    msg = [{"role": "user", "content": "Caption the image"}]
    kw = dict(tokenize=False, date_string="01 Jan 2020")
    assert PORT.apply_chat_template(msg, **kw) == REF.apply_chat_template(msg, **kw)
    assert "Today Date: 26 Jul 2024" in tok_fixture.chat_render.render(
        LLAMA31_CHAT_TEMPLATE, msg, "<|begin_of_text|>")[0]
    PORT.chat_template = "{{ messages }}"
    with pytest.raises(NotImplementedError):
        PORT.apply_chat_template(msg)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(ASCII, ASCII), min_size=1, max_size=3))
def test_chat_masks_on_printable_ascii(pairs):
    chats = [[{"role": "user", "content": u}, {"role": "assistant", "content": a}]
             for u, a in pairs]
    kw = dict(tokenize=True, return_dict=True, return_assistant_tokens_mask=True)
    a, b = REF.apply_chat_template(chats, **kw), PORT.apply_chat_template(chats, **kw)
    assert b["input_ids"] == a["input_ids"]
    assert b["assistant_masks"] == a["assistant_masks"]
