"""Porter stemmer, the original 1980 algorithm — the METEOR scorer's stem
stage.

A Python copy of the JAX package's C++ stemmer (``sat_tpu/native``), which
that package's METEOR uses on ASCII text and keeps in lockstep with
nltk's ``PorterStemmer(mode="ORIGINAL_ALGORITHM")``.  The port needs
neither the native library nor nltk.
"""

from __future__ import annotations

from functools import lru_cache

_VOWELS = frozenset("aeiou")


def _is_consonant(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return True if i == 0 else not _is_consonant(w, i - 1)
    return True


def _measure(w: str) -> int:
    """m(): the number of VC sequences in ``w``."""
    m, i, n = 0, 0, len(w)
    while i < n and _is_consonant(w, i):        # leading C*
        i += 1
    while i < n:
        while i < n and not _is_consonant(w, i):    # V+
            i += 1
        if i >= n:
            break
        while i < n and _is_consonant(w, i):        # C+
            i += 1
        m += 1
    return m


def _contains_vowel(w: str) -> bool:
    return any(not _is_consonant(w, i) for i in range(len(w)))


def _double_consonant(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_consonant(w, len(w) - 1)


def _ends_cvc(w: str) -> bool:
    """*o: the stem ends consonant-vowel-consonant, the last not w, x or y."""
    return (
        len(w) >= 3
        and _is_consonant(w, len(w) - 3)
        and not _is_consonant(w, len(w) - 2)
        and _is_consonant(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def _apply_rules(w: str, rules) -> str:
    """The first rule whose suffix matches decides: its replacement applies
    when m(stem) > 0; later rules are not tried either way."""
    for suf, rep in rules:
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            return stem + rep if _measure(stem) > 0 else w
    return w


_STEP2 = (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
    ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
)
_STEP3 = (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
)
_STEP4 = (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
    "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
)


@lru_cache(maxsize=65536)  # corpora re-stem the same caption vocabulary
def stem(word: str) -> str:
    """Lowercase, then the five steps, with no short-word guard (nltk's
    ORIGINAL_ALGORITHM applies them to words of every length)."""
    w = word.lower()
    if not w:
        return w

    # step 1a
    if w.endswith("sses") or w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    did_1b_23 = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _contains_vowel(w[:-2]):
            w, did_1b_23 = w[:-2], True
    elif w.endswith("ing"):
        if _contains_vowel(w[:-3]):
            w, did_1b_23 = w[:-3], True
    if did_1b_23:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _double_consonant(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # steps 2 and 3 (m > 0)
    w = _apply_rules(w, _STEP2)
    w = _apply_rules(w, _STEP3)

    # step 4 (m > 1; 'ion' also needs the stem to end in s or t)
    for suf in _STEP4:
        if w.endswith(suf):
            stem_ = w[: len(w) - len(suf)]
            if _measure(stem_) > 1 and (suf != "ion" or stem_[-1:] in ("s", "t")):
                w = stem_
            break  # the first suffix match decides

    # step 5a
    if w.endswith("e"):
        stem_ = w[:-1]
        m = _measure(stem_)
        if m > 1 or (m == 1 and not _ends_cvc(stem_)):
            w = stem_
    # step 5b
    if _measure(w) > 1 and _double_consonant(w) and w.endswith("l"):
        w = w[:-1]
    return w
