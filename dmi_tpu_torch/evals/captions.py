# Copy of dmi_tpu/evals/captions.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Generic caption metrics (HF `evaluate` equivalents).

caption_evaluate mirrors the reference's evaluate-based rouge/bleu/meteor
combo (dmi/utils/eval_utils.py:77-97); caption_evaluate_chebi20 mirrors the
SciBERT-tokenized corpus-BLEU + METEOR + rouge_scorer path (:24-74).

SciBERT's vocab file is unavailable offline; get_chebi_tokenizer falls back
to transformers' pure-python BasicTokenizer (lowercasing + punct splitting),
which tracks the wordpiece tokenization closely on molecule descriptions —
documented approximation, swapped for the real SciBERT tokenizer whenever
the HF cache provides it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
from rouge_score import rouge_scorer

from dmi_tpu_torch.evals.bleu import hf_bleu
from dmi_tpu_torch.evals.meteor import meteor as native_meteor
from dmi_tpu_torch.evals.tokenize import tokenizer_13a

Refs = Union[str, Sequence[str]]


def _as_list(refs: Refs) -> List[str]:
    return [refs] if isinstance(refs, str) else list(refs)


def get_chebi_tokenizer():
    try:
        from transformers import BertTokenizerFast

        tok = BertTokenizerFast.from_pretrained(
            "allenai/scibert_scivocab_uncased", local_files_only=True
        )
        return lambda text: [
            t for t in tok.tokenize(text, truncation=True, max_length=802)
            if t not in ("[PAD]", "[CLS]", "[SEP]")
        ]
    except Exception:
        from transformers.models.bert.tokenization_bert import BasicTokenizer

        basic = BasicTokenizer(do_lower_case=True)
        return lambda text: basic.tokenize(text)[:802]


def caption_evaluate(
    preds: List[str], gts: List[Refs], tokenizer=None
) -> Dict[str, float]:
    """rouge1/2/L/Lsum + bleu + meteor on raw texts (multi-ref aware)."""
    tok = tokenizer if tokenizer is not None else tokenizer_13a

    scorer = rouge_scorer.RougeScorer(
        ["rouge1", "rouge2", "rougeL", "rougeLsum"], use_stemmer=False
    )
    rouge_acc = {k: [] for k in ("rouge1", "rouge2", "rougeL", "rougeLsum")}
    for pred, refs in zip(preds, gts):
        refs_l = _as_list(refs)
        if len(refs_l) == 1:
            rs = scorer.score(refs_l[0], pred)
        else:
            rs = scorer.score_multi(refs_l, pred)
        for k in rouge_acc:
            rouge_acc[k].append(rs[k].fmeasure)
    rouge_scores = {k: float(np.mean(v)) for k, v in rouge_acc.items()}

    cands_tok = [tok(p) for p in preds]
    refs_tok = [[tok(r) for r in _as_list(refs)] for refs in gts]
    bleu = hf_bleu(cands_tok, refs_tok)

    meteor_vals = [
        native_meteor(r_toks, c_toks) for c_toks, r_toks in zip(cands_tok, refs_tok)
    ]
    return {**rouge_scores, "bleu": bleu, "meteor": float(np.mean(meteor_vals))}


def caption_evaluate_chebi20(
    predictions: List[str], targets: List[str], tokenizer=None
) -> Dict[str, float]:
    """SciBERT-tokenized corpus BLEU-4 + METEOR + rouge1/2/L, all x100
    (dmi/utils/eval_utils.py:24-74)."""
    from nltk.translate.bleu_score import corpus_bleu

    tok = tokenizer if tokenizer is not None else get_chebi_tokenizer()

    references, hypotheses, meteor_scores = [], [], []
    for gt, out in zip(targets, predictions):
        gt_tokens = tok(gt)
        out_tokens = tok(out)
        references.append([gt_tokens])
        hypotheses.append(out_tokens)
        meteor_scores.append(native_meteor([gt_tokens], out_tokens))

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bleu = corpus_bleu(references, hypotheses, weights=(0.25, 0.25, 0.25, 0.25)) * 100

    meteor_val = float(np.mean(meteor_scores)) * 100

    scorer = rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"])
    rs_all = [scorer.score(out, gt) for gt, out in zip(targets, predictions)]
    return {
        "rouge1": float(np.mean([r["rouge1"].fmeasure for r in rs_all])) * 100,
        "rouge2": float(np.mean([r["rouge2"].fmeasure for r in rs_all])) * 100,
        "rougeL": float(np.mean([r["rougeL"].fmeasure for r in rs_all])) * 100,
        "bleu": bleu,
        "meteor": meteor_val,
    }
