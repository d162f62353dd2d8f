"""The port's stand-ins for the scorers' third-party packages, each against
its original here: the Porter and Snowball stemmers (dmi_tpu_torch/evals/
stem.py) against nltk, RougeScorer against rouge_score, corpus BLEU against
nltk's, BasicTokenizer against transformers'.  Equality is exact (floats
within 1e-12).  The card's machine has none of those packages; the copied
scorers (meteor.py, meteor15.py, captions.py) import these instead.
"""

import math
import random
import re
import warnings
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.stem.porter import PorterStemmer as NltkPorter
from nltk.stem.snowball import SnowballStemmer as NltkSnowball
from nltk.translate.bleu_score import corpus_bleu as nltk_corpus_bleu
from rouge_score import rouge_scorer as reference_rouge
from transformers.models.bert.tokenization_bert import BasicTokenizer as HFBasicTokenizer

from dmi_tpu.data.fixtures import CAPTION_BANK
from dmi_tpu_torch.evals import rouge_scorer
from dmi_tpu_torch.evals.basic_tokenizer import BasicTokenizer
from dmi_tpu_torch.evals.nltk_bleu import corpus_bleu
from dmi_tpu_torch.evals.stem import PorterStemmer, SnowballStemmer

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
# every word of the evals tests' corpora and of the fixture captions
WORDS = sorted({w for f in ("test_evals.py", "test_meteor15.py")
                for w in re.findall(r"[A-Za-z']+", (TESTS / f).read_text())}
               | {w for c in CAPTION_BANK for w in c.split()})
# suffixes each stemmer's steps read, to build words that reach every rule
SUFFIXES = ["ational", "tional", "enci", "anci", "izer", "bli", "alli", "entli", "eli",
            "ousli", "ization", "ation", "ator", "alism", "iveness", "fulness", "ousness",
            "aliti", "iviti", "biliti", "fulli", "logi", "icate", "ative", "alize", "iciti",
            "ical", "ful", "ness", "al", "ance", "ence", "er", "ic", "able", "ible", "ant",
            "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize", "e",
            "ll", "ies", "ied", "sses", "ss", "s", "eed", "ed", "ing", "y", "eedly", "ingly",
            "edly", "lessli", "ogi", "li", "'s", "'", "us", "'s'"]
STEMS = st.text("aeiouybcdglmnrstwxz'", min_size=0, max_size=7)
LOWER_WORDS = st.one_of(st.text("abcdefghijklmnopqrstuvwxyz", min_size=1, max_size=12),
                        st.tuples(st.sampled_from(["", "gener", "commun", "arsen", "y", "'"]),
                                  STEMS, st.sampled_from(SUFFIXES)).map("".join))


def _constructed_words(n=4000):
    rng = random.Random(0)
    return ["".join(rng.choice("aeiouybcdglmnrstwxz") for _ in range(rng.randint(1, 6)))
            + rng.choice(SUFFIXES) for _ in range(n)]


@pytest.mark.parametrize("name", ["porter", "snowball"])
def test_stemmer_matches_nltk_on_the_corpora(name):
    ours, theirs = ((PorterStemmer(), NltkPorter()) if name == "porter"
                    else (SnowballStemmer("english"), NltkSnowball("english")))
    words = WORDS + [w.upper() for w in WORDS[:50]] + _constructed_words()
    assert len(WORDS) > 200
    diff = [(w, ours.stem(w), theirs.stem(w)) for w in words if ours.stem(w) != theirs.stem(w)]
    assert not diff, diff[:20]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(LOWER_WORDS)
def test_stemmers_match_nltk_on_lowercase_words(word):
    assert PorterStemmer().stem(word) == NltkPorter().stem(word)
    assert SnowballStemmer("english").stem(word) == NltkSnowball("english").stem(word)


def test_snowball_refuses_other_languages():
    with pytest.raises(NotImplementedError):
        SnowballStemmer("german")


ROUGE_TYPES = ["rouge1", "rouge2", "rougeL", "rougeLsum"]
VOCAB = ("a dog Dog runs ran the The water, galaxy. spiral-arm molecule's acid; café "
         "naïve x\tY 42 3.5").split(" ") + ["\n", "", " "]


def _sentence(rng):
    return " ".join(rng.choice(VOCAB) for _ in range(rng.randint(0, 14)))


def _same_score(a, b):
    assert set(a) == set(b)
    for k in a:
        assert type(b[k]).__name__ == "Score" and b[k]._fields == a[k]._fields
        for x, y in zip(a[k], b[k]):
            assert math.isclose(x, y, rel_tol=0, abs_tol=1e-12), (k, a[k], b[k])


@pytest.mark.parametrize("use_stemmer", [False, True])
def test_rouge_matches_rouge_score(use_stemmer):
    rng = random.Random(int(use_stemmer))
    ours = rouge_scorer.RougeScorer(ROUGE_TYPES, use_stemmer=use_stemmer)
    theirs = reference_rouge.RougeScorer(ROUGE_TYPES, use_stemmer=use_stemmer)
    cases = [(c, p) for c in CAPTION_BANK for p in CAPTION_BANK[:3]]
    cases += [(_sentence(rng), _sentence(rng)) for _ in range(300)]
    cases += [("", "a dog"), ("a dog", ""), ("line one\nline two", "line two\nline one")]
    for target, prediction in cases:
        _same_score(ours.score(target, prediction), theirs.score(target, prediction))
    for _ in range(150):
        targets = [_sentence(rng) for _ in range(rng.randint(1, 4))]
        prediction = _sentence(rng)
        _same_score(ours.score_multi(targets, prediction),
                    theirs.score_multi(targets, prediction))


def test_rouge_single_types_and_refusals():
    for types in (["rougeLsum"], ["rouge1"], ["rouge3", "rougeL"]):
        _same_score(rouge_scorer.RougeScorer(types).score("a b c\nd e", "a c\nd"),
                    reference_rouge.RougeScorer(types).score("a b c\nd e", "a c\nd"))
    with pytest.raises(ValueError):
        rouge_scorer.RougeScorer(["rougeX"]).score("a", "a")


@pytest.mark.parametrize("weights", [(0.25, 0.25, 0.25, 0.25), (0.5, 0.5), (1.0,),
                                     (0.1, 0.2, 0.3, 0.4)])
def test_corpus_bleu_matches_nltk(weights):
    """Random corpora with one to three references, among them hypotheses
    with no 4-gram match (nltk's smallest-float precision) and a corpus with
    no unigram match (0)."""
    rng = random.Random(len(weights))
    words = "a dog runs on the grass near water".split()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(300):
            n = rng.randint(1, 4)
            refs = [[[rng.choice(words) for _ in range(rng.randint(0, 9))]
                     for _ in range(rng.randint(1, 3))] for _ in range(n)]
            hyps = [[rng.choice(words) for _ in range(rng.randint(0, 9))] for _ in range(n)]
            want, got = nltk_corpus_bleu(refs, hyps, weights=weights), corpus_bleu(
                refs, hyps, weights=weights)
            assert math.isclose(got, want, rel_tol=0, abs_tol=1e-12), (refs, hyps, got, want)
        no_4gram = ([[["a", "dog", "runs", "on", "grass"]]], [["a", "dog", "runs", "grass"]])
        assert nltk_corpus_bleu(*no_4gram, weights=weights) == corpus_bleu(*no_4gram,
                                                                           weights=weights)
        disjoint = ([[["a", "dog"]]], [["the", "cat"]])
        assert corpus_bleu(*disjoint, weights=weights) == 0 == nltk_corpus_bleu(
            *disjoint, weights=weights)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.text(st.sampled_from(list("aZ é́Ë!?.,;:-()[]$^`~中文\t\n\r\x00�\x07ßİǅ3"
                                  "　 ")), max_size=30))
def test_basic_tokenizer_matches_transformers(text):
    assert BasicTokenizer(do_lower_case=True).tokenize(text) == HFBasicTokenizer(
        do_lower_case=True).tokenize(text)


def test_basic_tokenizer_on_molecule_descriptions():
    texts = ["The molecule is an Organic ACID (a Carboxylic-acid); it's a conjugate base.",
             "Naïve CAFÉ: 2,4-dinitrophenol — ÉTHANOL, 中文 text!", *CAPTION_BANK]
    for text in texts:
        assert BasicTokenizer(do_lower_case=True).tokenize(text) == HFBasicTokenizer(
            do_lower_case=True).tokenize(text)
