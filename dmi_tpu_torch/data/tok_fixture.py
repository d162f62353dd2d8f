# Copy of dmi_tpu/data/tok_fixture.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Offline tokenizer fixture with Llama-3 chat semantics.

The real runs use the HF Llama tokenizer (reference:
dmi/utils/model_utils.py:8-15); this environment has no network/model
cache, so tests and synthetic end-to-end runs build a tiny byte-level BPE
tokenizer locally with the same special tokens and our Llama-3.2 chat
template (generation tags included) — every collator/label-masking/decode
semantic exercises the same HF fast-tokenizer code paths as production.
"""

from __future__ import annotations

from typing import Iterable, Optional

from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
from transformers import PreTrainedTokenizerFast

from dmi_tpu_torch.chat_templates import LLAMA32_CHAT_TEMPLATE

SPECIAL_TOKENS = [
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|eot_id|>",
    "<|eom_id|>",
]

DEFAULT_CORPUS = [
    "Caption the image",
    "Caption the audio",
    "Describe the video",
    "Describe the satellite image",
    "Describe the galaxy in the image",
    "Describe the molecule",
    "a dog runs on green grass near the water",
    "two people walk along a sandy beach by the ocean",
    "an industrial area with many buildings and roads",
    "a residential area with dense houses and trees",
    "a spiral galaxy with a bright central bulge",
    "an elliptical smooth round galaxy",
    "the molecule is an organic acid with a carboxyl group",
    "it is a conjugate base of a weak acid",
    "Cutting Knowledge Date: December 2023",
    "Today Date: 16 Aug 2026",
    "system user assistant",
]


def build_test_tokenizer(
    corpus: Optional[Iterable[str]] = None, vocab_size: int = 512
) -> PreTrainedTokenizerFast:
    corpus = list(corpus) if corpus is not None else DEFAULT_CORPUS
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=SPECIAL_TOKENS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(corpus, trainer)

    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok,
        bos_token="<|begin_of_text|>",
        eos_token="<|eot_id|>",
        additional_special_tokens=[
            t for t in SPECIAL_TOKENS if t not in ("<|begin_of_text|>", "<|eot_id|>")
        ],
        padding_side="right",
    )
    # reference build_tokenizer: pad = eos, custom chat template
    # (dmi/utils/model_utils.py:8-15)
    fast.pad_token = fast.eos_token
    fast.chat_template = LLAMA32_CHAT_TEMPLATE
    return fast
