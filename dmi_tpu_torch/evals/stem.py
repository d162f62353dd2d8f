"""English stemmers of the METEOR scorers, in pure Python.

PorterStemmer is nltk's Porter stemmer in its default NLTK_EXTENSIONS mode
(nltk/stem/porter.py): Porter's 1980 rules with nltk's irregular forms, the
"ies"/"ied" and "alli"/"fulli"/"logi" departures and the two-letter cvc
test.  SnowballStemmer("english") is nltk's Snowball Porter2 stemmer
(nltk/stem/snowball.py, EnglishStemmer) without stopwords.  Each .stem(word)
lowercases and returns what nltk returns; tests/test_torch_evals_standalone.py
holds both to nltk word for word.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiou")


class PorterStemmer:
    """nltk.stem.porter.PorterStemmer() (mode NLTK_EXTENSIONS)."""

    _POOL = {form: base for base, forms in {
        "sky": ["sky", "skies"], "die": ["dying"], "lie": ["lying"], "tie": ["tying"],
        "news": ["news"], "inning": ["innings", "inning"], "outing": ["outings", "outing"],
        "canning": ["cannings", "canning"], "howe": ["howe"], "proceed": ["proceed"],
        "exceed": ["exceed"], "succeed": ["succeed"]}.items() for form in forms}

    # ------------------------------------------------------------------ tests
    @staticmethod
    def _cons(word, i):
        if word[i] in _VOWELS:
            return False
        if word[i] == "y":
            # a y is a consonant after a vowel; a run of y's alternates
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in _VOWELS) != negate
        return True

    def _m(self, stem):
        """Porter's measure: the number of vowel-consonant sequences."""
        seq = "".join("c" if self._cons(stem, i) else "v" for i in range(len(stem)))
        return seq.count("vc")

    def _has_vowel(self, stem):
        return any(not self._cons(stem, i) for i in range(len(stem)))

    def _double_cons(self, word):
        return len(word) >= 2 and word[-1] == word[-2] and self._cons(word, len(word) - 1)

    def _cvc(self, word):
        n = len(word)
        return (n >= 3 and self._cons(word, n - 3) and not self._cons(word, n - 2)
                and self._cons(word, n - 1) and word[-1] not in "wxy") or (
            n == 2 and not self._cons(word, 0) and self._cons(word, 1))

    def _pos(self, stem):
        return self._m(stem) > 0

    def _rules(self, word, rules):
        """The first rule whose suffix ends the word decides: it rewrites the
        word if its condition holds on the stem, else leaves it.  The suffix
        "*d" stands for a double consonant."""
        for suffix, repl, cond in rules:
            if suffix == "*d" and self._double_cons(word):
                stem = word[:-2]
                return stem + repl if cond is None or cond(stem) else word
            if word.endswith(suffix):
                stem = word[:len(word) - len(suffix)]
                return stem + repl if cond is None or cond(stem) else word
        return word

    # ------------------------------------------------------------------ steps
    def _step1a(self, word):
        if word.endswith("ies") and len(word) == 4:
            return word[:-3] + "ie"
        return self._rules(word, [("sses", "ss", None), ("ies", "i", None),
                                  ("ss", "ss", None), ("s", "", None)])

    def _step1b(self, word):
        if word.endswith("ied"):
            return word[:-3] + ("ie" if len(word) == 4 else "i")
        if word.endswith("eed"):
            stem = word[:-3]
            return stem + "ee" if self._m(stem) > 0 else word
        for suffix in ("ed", "ing"):
            if word.endswith(suffix) and self._has_vowel(word[:-len(suffix)]):
                stem = word[:-len(suffix)]
                break
        else:
            return word
        return self._rules(stem, [
            ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
            ("*d", stem[-1], lambda s: stem[-1] not in ("l", "s", "z")),
            ("", "e", lambda s: self._m(s) == 1 and self._cvc(s)),
        ])

    def _step1c(self, word):
        return self._rules(word, [("y", "i", lambda s: len(s) > 1 and self._cons(s, len(s) - 1))])

    def _step2(self, word):
        if word.endswith("alli") and self._pos(word[:-4]):
            return self._step2(word[:-4] + "al")
        p = self._pos
        return self._rules(word, [
            ("ational", "ate", p), ("tional", "tion", p), ("enci", "ence", p),
            ("anci", "ance", p), ("izer", "ize", p), ("bli", "ble", p), ("alli", "al", p),
            ("entli", "ent", p), ("eli", "e", p), ("ousli", "ous", p), ("ization", "ize", p),
            ("ation", "ate", p), ("ator", "ate", p), ("alism", "al", p), ("iveness", "ive", p),
            ("fulness", "ful", p), ("ousness", "ous", p), ("aliti", "al", p),
            ("iviti", "ive", p), ("biliti", "ble", p), ("fulli", "ful", p),
            ("logi", "log", lambda s: p(word[:-3])),
        ])

    def _step3(self, word):
        p = self._pos
        return self._rules(word, [("icate", "ic", p), ("ative", "", p), ("alize", "al", p),
                                  ("iciti", "ic", p), ("ical", "ic", p), ("ful", "", p),
                                  ("ness", "", p)])

    def _step4(self, word):
        def gt1(s):
            return self._m(s) > 1

        return self._rules(word, [
            *((s, "", gt1) for s in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                                     "ement", "ment", "ent")),
            ("ion", "", lambda s: self._m(s) > 1 and s[-1] in ("s", "t")),
            *((s, "", gt1) for s in ("ou", "ism", "ate", "iti", "ous", "ive", "ize")),
        ])

    def _step5a(self, word):
        if word.endswith("e"):
            stem = word[:-1]
            m = self._m(stem)
            if m > 1 or (m == 1 and not self._cvc(stem)):
                return stem
        return word

    def _step5b(self, word):
        return self._rules(word, [("ll", "l", lambda s: self._m(word[:-1]) > 1)])

    def stem(self, word: str) -> str:
        stem = word.lower()
        if stem in self._POOL:
            return self._POOL[stem]
        if len(word) <= 2:
            return stem
        for step in (self._step1a, self._step1b, self._step1c, self._step2, self._step3,
                     self._step4, self._step5a, self._step5b):
            stem = step(stem)
        return stem


# --------------------------------------------------------------------- Snowball
_SV = "aeiouy"  # Snowball's English vowels
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = "cdeghkmnrt"
_STEP0 = ("'s'", "'s", "'")
_STEP1A = ("sses", "ied", "ies", "us", "ss", "s")
_STEP1B = ("eedly", "ingly", "edly", "eed", "ing", "ed")
_STEP2 = ("ization", "ational", "fulness", "ousness", "iveness", "tional", "biliti", "lessli",
          "entli", "ation", "alism", "aliti", "ousli", "iviti", "fulli", "enci", "anci", "abli",
          "izer", "ator", "alli", "bli", "ogi", "li")
_STEP3 = ("ational", "tional", "alize", "icate", "iciti", "ative", "ical", "ness", "ful")
_STEP4 = ("ement", "ance", "ence", "able", "ible", "ment", "ant", "ent", "ism", "ate", "iti",
          "ous", "ive", "ize", "ion", "al", "er", "ic")
_SPECIAL = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli", "early": "earli", "only": "onli",
    "singly": "singl", "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes", "inning": "inning",
    "innings": "inning", "outing": "outing", "outings": "outing", "canning": "canning",
    "cannings": "canning", "herring": "herring", "herrings": "herring", "earring": "earring",
    "earrings": "earring", "proceed": "proceed", "proceeds": "proceed",
    "proceeded": "proceed", "proceeding": "proceed", "exceed": "exceed", "exceeds": "exceed",
    "exceeded": "exceed", "exceeding": "exceed", "succeed": "succeed", "succeeds": "succeed",
    "succeeded": "succeed", "succeeding": "succeed",
}
# step 2's and 3's replacements: suffix -> (new ending, r2 when r2 is shorter
# than the suffix).  nltk keeps r2 = "e" for "ate"/"ive" there, and that
# decides step 5 for some words
_REPLACE2 = {"izer": ("ize", ""), "ization": ("ize", ""), "ational": ("ate", "e"),
             "ation": ("ate", "e"), "ator": ("ate", "e"), "alism": ("al", ""),
             "aliti": ("al", ""), "alli": ("al", ""), "ousli": ("ous", ""),
             "ousness": ("ous", ""), "iveness": ("ive", "e"), "iviti": ("ive", "e"),
             "biliti": ("ble", ""), "bli": ("ble", "")}
_REPLACE3 = {"ational": ("ate", ""), "icate": ("ic", ""), "iciti": ("ic", ""),
             "ical": ("ic", "")}


def _r1(word):
    for i in range(1, len(word)):
        if word[i] not in _SV and word[i - 1] in _SV:
            return word[i + 1:]
    return ""


def _replace(word, r1, r2, suffix, new, r2_short=""):
    n = len(suffix)
    return (word[:-n] + new, r1[:-n] + new if len(r1) >= n else "",
            r2[:-n] + new if len(r2) >= n else r2_short)


def _cut(word, r1, r2, n):
    return word[:-n], r1[:-n], r2[:-n]


class _EnglishSnowball:
    """nltk.stem.snowball.EnglishStemmer() (no stopwords)."""

    def stem(self, word: str) -> str:
        word = word.lower()
        if len(word) <= 2:
            return word
        if word in _SPECIAL:
            return _SPECIAL[word]
        word = word.replace("’", "'").replace("‘", "'").replace("‛", "'")
        if word.startswith("'"):
            word = word[1:]
        if word.startswith("y"):
            word = "Y" + word[1:]
        for i in range(1, len(word)):
            if word[i - 1] in _SV and word[i] == "y":
                word = word[:i] + "Y" + word[i + 1:]

        if word.startswith(("gener", "commun", "arsen")):
            r1 = word[6:] if word.startswith("commun") else word[5:]
        else:
            r1 = _r1(word)
        r2 = _r1(r1)

        for suffix in _STEP0:
            if word.endswith(suffix):
                word, r1, r2 = _cut(word, r1, r2, len(suffix))
                break

        for suffix in _STEP1A:
            if word.endswith(suffix):
                if suffix == "sses":
                    word, r1, r2 = _cut(word, r1, r2, 2)
                elif suffix in ("ied", "ies"):
                    word, r1, r2 = _cut(word, r1, r2, 2 if len(word) - 3 > 1 else 1)
                elif suffix == "s" and any(c in _SV for c in word[:-2]):
                    word, r1, r2 = _cut(word, r1, r2, 1)
                break

        for suffix in _STEP1B:
            if word.endswith(suffix):
                if suffix in ("eed", "eedly"):
                    if r1.endswith(suffix):
                        n = len(suffix)
                        word = word[:-n] + "ee"
                        r1 = r1[:-n] + "ee" if len(r1) >= n else ""
                        r2 = r2[:-n] + "ee" if len(r2) >= n else ""
                elif any(c in _SV for c in word[:-len(suffix)]):
                    word, r1, r2 = _cut(word, r1, r2, len(suffix))
                    if word.endswith(("at", "bl", "iz")):
                        word, r1 = word + "e", r1 + "e"
                        if len(word) > 5 or len(r1) >= 3:
                            r2 += "e"
                    elif word.endswith(_DOUBLES):
                        word, r1, r2 = _cut(word, r1, r2, 1)
                    elif r1 == "" and (
                        (len(word) >= 3 and word[-1] not in _SV and word[-1] not in "wxY"
                         and word[-2] in _SV and word[-3] not in _SV)
                        or (len(word) == 2 and word[0] in _SV and word[1] not in _SV)):
                        word += "e"
                        if r1:
                            r1 += "e"
                        if r2:
                            r2 += "e"
                break

        if len(word) > 2 and word[-1] in "yY" and word[-2] not in _SV:
            word = word[:-1] + "i"
            r1 = r1[:-1] + "i" if r1 else ""
            r2 = r2[:-1] + "i" if r2 else ""

        for suffix in _STEP2:
            if word.endswith(suffix):
                if r1.endswith(suffix):
                    if suffix in ("tional", "entli", "fulli", "lessli"):
                        word, r1, r2 = _cut(word, r1, r2, 2)
                    elif suffix in ("enci", "anci", "abli"):
                        word = word[:-1] + "e"
                        r1 = r1[:-1] + "e" if r1 else ""
                        r2 = r2[:-1] + "e" if r2 else ""
                    elif suffix in _REPLACE2:
                        new, short = _REPLACE2[suffix]
                        word, r1, r2 = _replace(word, r1, r2, suffix, new, short)
                    elif suffix == "fulness":
                        word, r1, r2 = _cut(word, r1, r2, 4)
                    elif suffix == "ogi" and word[-4] == "l":
                        word, r1, r2 = _cut(word, r1, r2, 1)
                    elif suffix == "li" and word[-3] in _LI_ENDING:
                        word, r1, r2 = _cut(word, r1, r2, 2)
                break

        for suffix in _STEP3:
            if word.endswith(suffix):
                if r1.endswith(suffix):
                    if suffix == "tional":
                        word, r1, r2 = _cut(word, r1, r2, 2)
                    elif suffix in _REPLACE3:
                        new, short = _REPLACE3[suffix]
                        word, r1, r2 = _replace(word, r1, r2, suffix, new, short)
                    elif suffix == "alize":
                        word, r1, r2 = _cut(word, r1, r2, 3)
                    elif suffix in ("ful", "ness"):
                        word, r1, r2 = _cut(word, r1, r2, len(suffix))
                    elif suffix == "ative" and r2.endswith(suffix):
                        word, r1, r2 = _cut(word, r1, r2, 5)
                break

        for suffix in _STEP4:
            if word.endswith(suffix):
                if r2.endswith(suffix):
                    if suffix != "ion":
                        word, r1, r2 = _cut(word, r1, r2, len(suffix))
                    elif word[-4] in "st":
                        word, r1, r2 = _cut(word, r1, r2, 3)
                break

        if r2.endswith("l") and word[-2] == "l":
            word = word[:-1]
        elif r2.endswith("e"):
            word = word[:-1]
        elif r1.endswith("e") and len(word) >= 4 and (
                word[-2] in _SV or word[-2] in "wxY" or word[-3] not in _SV
                or word[-4] in _SV):
            word = word[:-1]
        return word.replace("Y", "y")


class SnowballStemmer:
    """nltk.stem.snowball.SnowballStemmer, English only."""

    def __init__(self, language: str = "english"):
        if language != "english":
            raise NotImplementedError(f"SnowballStemmer({language!r}): only English is ported")
        self.stem = _EnglishSnowball().stem
