"""Penn-Treebank-style word tokenizer — the port's copy of
``sat_tpu.data.tokenizer``'s pure-Python rule set.

The JAX package routes ASCII text through its C++ tokenizer when built and
golden-tests it against these rules; the port keeps only the rules, so it
needs no native library.
"""

from __future__ import annotations

import re
from typing import List

# Treebank contraction suffixes: don't -> do n't, it's -> it 's, etc.
_CONTRACTIONS = re.compile(r"([^' ])('ll|'re|'ve|n't|'s|'m|'d)\b", re.IGNORECASE)
# Multi-word contractions treated as single splits by Treebank rules.
_CONTRACTIONS2 = [
    (re.compile(r"\b(can)(not)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(gon)(na)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(got)(ta)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(wan)(na)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(lem)(me)\b", re.IGNORECASE), r"\1 \2"),
]

_RULES = [
    # Starting quotes.
    (re.compile(r'^\"'), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r'([ (\[{<])(\"|\'{2})'), r"\1 `` "),
    # Ellipsis before other period handling.
    (re.compile(r"\.\.\."), r" ... "),
    # Most punctuation.
    (re.compile(r"([;@#$%&?!])"), r" \1 "),
    # Sentence-internal periods followed by whitespace (nltk's word_tokenize
    # sentence-splits first, so "a dog. runs." yields a separate '.').
    (re.compile(r"([^\.])(\.)(?=\s)"), r"\1 \2 "),
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),  # final period
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),   # comma/colon not in numbers
    (re.compile(r"([:,])$"), r" \1 "),
    # Parens, brackets.
    (re.compile(r"([\]\[\(\)\{\}<>])"), r" \1 "),
    (re.compile(r"--"), r" -- "),
    # Ending quotes.
    (re.compile(r'"'), r" '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])(' )"), r"\1 ' "),
]


def tokenize_pure(text: str, lower: bool = True) -> List[str]:
    """Pure-Python Treebank tokenization (reference rule set)."""
    if lower:
        text = text.lower()
    text = " " + text.strip() + " "
    for pattern, sub in _RULES:
        text = pattern.sub(sub, text)
    text = _CONTRACTIONS.sub(r"\1 \2", text)
    for pattern, sub in _CONTRACTIONS2:
        text = pattern.sub(sub, text)
    return text.split()


def tokenize(text: str, lower: bool = True) -> List[str]:
    """Tokenize one sentence into Treebank-style word tokens."""
    return tokenize_pure(text, lower=lower)
