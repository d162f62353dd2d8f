# Copy of dmi_tpu/evals/environment.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Eval-environment annotation for results JSONs.

Two offline fallbacks silently change metric VALUES at the config level
(VERDICT round 1, weak #4): METEOR without wordnet runs fewer matcher
stages, and chebi20 falls back SciBERT -> BasicTokenizer, which shifts the
chebi BLEU selection metric.  Results files therefore record exactly which
implementation ran, so a later parity audit can tell which numbers are
comparable against reference runs.
"""

from __future__ import annotations

from typing import Dict, Optional


def _chebi_tokenizer_kind() -> str:
    try:
        from transformers import BertTokenizerFast

        BertTokenizerFast.from_pretrained(
            "allenai/scibert_scivocab_uncased", local_files_only=True
        )
        return "scibert_scivocab_uncased"
    except Exception:
        return "basic_tokenizer_fallback"


def eval_environment(dataset_name: Optional[str] = None) -> Dict:
    """Static probe of which scorer implementations/stages run in this
    process environment.  Deterministic per environment (the fallbacks are
    availability-driven, not data-driven)."""
    from dmi_tpu_torch.evals.meteor15 import default_config
    from dmi_tpu_torch.evals.native import get_lib

    m_cfg = default_config()
    env: Dict = {
        "coco_meteor_impl": "meteor-1.5-native",
        "coco_meteor_stages": m_cfg.active_stages(),
        "generic_meteor_impl": "nltk-style-exact+stem",
        "ngram_core": "cpp" if get_lib() is not None else "python",
        # clean-room PTB3 model of the Java PTBTokenizer+wrapper pipeline;
        # documented divergences: no americanize, no \/ \* escapes, single
        # initials split (dmi_tpu/evals/tokenize.py docstring; adversarial
        # suite: tests/test_ptb_tokenizer.py)
        "ptb_tokenizer_impl": "ptb3-clean-room",
    }
    if dataset_name == "chebi20":
        env["chebi_tokenizer"] = _chebi_tokenizer_kind()
    return env
