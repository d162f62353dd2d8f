# Copy of dmi_tpu/evals/__init__.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Native evaluation harness.

The reference calls a Java-backed cococap package (Stanford PTBTokenizer +
CIDEr/BLEU/METEOR/ROUGE jars) through a subprocess for candels/sydney
(dmi/utils/eval_utils.py:183-207) and HF `evaluate` for the generic caption
metrics (:77-97).  Neither the JVM stack nor `evaluate` exists in this
environment, and a Python→JVM process boundary has no place in a TPU-native
framework — so the scorers are implemented natively:

  * cider.py  — CIDEr-D exactly per the pycocoevalcap algorithm
  * bleu.py   — COCO corpus BLEU (closest-ref-length, tiny/small epsilons)
                and the HF-`evaluate`-style BLEU used for generic metrics
  * rouge.py  — COCO ROUGE-L (beta=1.2, max over refs)
  * meteor.py — METEOR with exact + Porter-stem stages (the wordnet synonym
                stage of METEOR-1.5 needs corpus data this image lacks;
                documented approximation)
  * tokenize.py — PTB-style tokenizer matching the Java PTBTokenizer's
                behavior on caption text (lowercase, punctuation stripped)
"""
