"""Train the fixture tokenizer in Llama-3's layout and record what
transformers computes over it (runs only where tokenizers and transformers
are installed; the card's machine has neither).

    python scripts/torch_llama3_tok_fixture.py

1. Trains a byte-level BPE with `tokenizers` under Llama-3's pre-tokenizer
   (Split on its pattern, then ByteLevel without its regex) on dmi_tpu's
   fixture corpus (dmi_tpu/data/tok_fixture.py's DEFAULT_CORPUS), the
   caption and prefix banks of data.fixtures and the lines of
   docs/SERVING.md (without which the merges run out near 500 entries), and
   adds UNMERGED, whole words that the merges cannot reach (ignore_merges
   encodes each as one token).  Its vocab (in id order) and merges go to
   dmi_tpu_torch/data/llama3_tok_fixture.json, from which
   hf_tokenizer.write_llama3_tokenizer_dir writes the full directory
   (128000 vocab ids, Llama-3.2's 256 special tokens, its post-processor and
   tokenizer_config.json).
2. Loads that directory with transformers' PreTrainedTokenizerFast and
   writes its ids (with and without special tokens), decodes (with and
   without skip_special_tokens, with its clean-up of spaces), chat renders,
   chat ids and assistant masks on GOLDEN_TEXTS and GOLDEN_CHATS to
   dmi_tpu_torch/data/llama3_tok_golden.json, which chip_smoke.py holds the
   port's reader to on the card.
3. Derives from tokenizers the letters and numbers its Oniguruma tables hold
   and Python's unicodedata does not, and checks hf_tokenizer's
   _ADDED_LETTERS and _ADDED_NUMBERS against them.
"""

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tokenizers import Regex, Tokenizer, models, pre_tokenizers, trainers  # noqa: E402
from transformers import PreTrainedTokenizerFast  # noqa: E402

from dmi_tpu.data.fixtures import CAPTION_BANK, PREFIX_BANK  # noqa: E402
from dmi_tpu.data.tok_fixture import DEFAULT_CORPUS  # noqa: E402
from dmi_tpu_torch.data import hf_tokenizer  # noqa: E402

VOCAB_SIZE = 1500
# pre-tokens the vocab holds whole and the merges cannot build
UNMERGED = ["Ġhelicopter", "Ġstadium", "Ġparking", "Ġgalaxies", "Ġmolecules", "Ġriverbank"]
GOLDEN_TEXTS = [
    "a dog runs on green grass near the water .",
    " a helicopter over the stadium , near a parking lot !",
    "Describe the galaxy in the image", "the molecule is an organic acid 1234567 .",
    "it's the dog's bone , isn't it ? they'll say 'SO' and I'D agree",
    "'ſa x'ſa 'Ka 'Sa 'LLama", "x\x1c\x1fy a\x85b a\xa0b a b　c", "été",
    "1 12 123 1234 12345 123456 1234567", "end.\r\n\r\nnext!!\n\nand?\r\n  \n x",
    "<|begin_of_text|>inside<|eot_id|> text <|eot_id <|reserved_special_token_7|>",
    "   leading spaces and trailing   ", "", "中文 émoji 😀 Ⅻ² ﬆ ß K",
]
GOLDEN_CHATS = [
    [{"role": "user", "content": "Describe the satellite image"},
     {"role": "assistant", "content": " an industrial area with many buildings and roads ."}],
    [{"role": "system", "content": "You caption images."},
     {"role": "user", "content": "Caption the image"},
     {"role": "assistant", "content": "a helicopter over the stadium , isn't it ?"}],
]
DATE = "01 Jan 2025"


def train() -> dict:
    """The trained vocab (token per id) and merges ("a b" strings)."""
    corpus = [*DEFAULT_CORPUS, *CAPTION_BANK, *(p for ps in PREFIX_BANK.values() for p in ps),
              *(REPO / "docs" / "SERVING.md").read_text(encoding="utf-8").splitlines()]
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(hf_tokenizer.LLAMA3_PATTERN), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    trainer = trainers.BpeTrainer(vocab_size=VOCAB_SIZE, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus, trainer)
    model = json.loads(tok.to_str())["model"]
    vocab = sorted(model["vocab"], key=model["vocab"].get)
    assert [model["vocab"][t] for t in vocab] == list(range(len(vocab)))
    assert not set(UNMERGED) & set(vocab)
    merges = [m if isinstance(m, str) else " ".join(m) for m in model["merges"]]
    return {"vocab": vocab + UNMERGED, "merges": merges}


def golden(directory) -> dict:
    """What transformers computes over the fixture directory."""
    ref = PreTrainedTokenizerFast.from_pretrained(str(directory))
    return hf_tokenizer.golden_outputs(ref, GOLDEN_TEXTS, GOLDEN_CHATS, DATE)


def unicode_additions() -> dict:
    """{"L": ranges, "N": ranges} of the code points that tokenizers' \\p{L}
    and \\p{N} match and unicodedata's categories do not."""
    import unicodedata

    codes = [c for c in range(0x110000) if not 0xD800 <= c < 0xE000]
    text = "".join(map(chr, codes))
    out = {}
    for name, pattern in (("L", r"\p{L}"), ("N", r"\p{N}")):
        split = pre_tokenizers.Split(Regex(pattern), behavior="removed", invert=False)
        kept = {k for _, (s, e) in split.pre_tokenize_str(text) for k in range(s, e)}
        extra = [c for k, c in enumerate(codes) if k not in kept
                 and unicodedata.category(chr(c))[0] != name]
        ranges = []
        for c in extra:
            if ranges and c == ranges[-1][1] + 1:
                ranges[-1] = (ranges[-1][0], c)
            else:
                ranges.append((c, c))
        out[name] = ranges
    return out


def main() -> int:
    spec = train()
    hf_tokenizer.FIXTURE_FILE.write_text(json.dumps(spec, ensure_ascii=False) + "\n",
                                         encoding="utf-8")
    with tempfile.TemporaryDirectory() as tmp:
        hf_tokenizer.write_llama3_tokenizer_dir(tmp)
        gold = golden(tmp)
    hf_tokenizer.GOLDEN_FILE.write_text(json.dumps(gold, ensure_ascii=False) + "\n",
                                        encoding="utf-8")
    print(f"wrote {hf_tokenizer.FIXTURE_FILE.name} ({len(spec['vocab'])} tokens, "
          f"{len(spec['merges'])} merges) and {hf_tokenizer.GOLDEN_FILE.name}")
    added = unicode_additions()
    tables = {"L": list(hf_tokenizer._ADDED_LETTERS), "N": list(hf_tokenizer._ADDED_NUMBERS)}
    print(f"hf_tokenizer's Unicode additions equal tokenizers': {added == tables} "
          f"(tokenizers: {added})")
    return 0 if added == tables else 1


if __name__ == "__main__":
    sys.exit(main())
