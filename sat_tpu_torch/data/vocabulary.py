"""Frequency-sorted caption vocabulary — the port's copy of
``sat_tpu.data.vocabulary``.

Index 0 is ``<start>``, the sentence terminator is the literal ``'.'``
token, and the on-disk format is the JAX package's pandas CSV (columns:
unnamed row index, word, index, frequency), so one ``vocabulary.csv``
serves both packages.  The port reads and writes it with the stdlib
``csv`` module instead of pandas; a word is always read as a string
(pandas' ``keep_default_na=False`` in the JAX package).
"""

from __future__ import annotations

import csv
import hashlib
import os
import string
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .tokenizer import tokenize


def vocab_fingerprint(path: str, size: int) -> Optional[Dict[str, object]]:
    """Content identity of the EFFECTIVE vocabulary a run decodes with:
    sha256 over the size-truncated word list plus its length — the same
    record the JAX package writes into a checkpoint's lineage sidecar, so
    a checkpoint trained against one vocabulary fails fast against
    another (``train.checkpoint.check_vocab``).  None when the file is
    missing or unreadable."""
    try:
        vocab = Vocabulary(size, os.path.abspath(path))
    except (OSError, ValueError, KeyError, csv.Error):
        return None
    return {
        "sha256": hashlib.sha256("\n".join(vocab.words).encode("utf-8")).hexdigest(),
        "size": len(vocab.words),
    }


class Vocabulary:
    def __init__(self, size: int, save_file: Optional[str] = None):
        self.words: List[str] = []
        self.word2idx: Dict[str, int] = {}
        self.word_frequencies: np.ndarray = np.zeros((0,), np.float64)
        self.size = size
        if save_file is not None:
            self.load(save_file)

    def build(self, sentences: Iterable[str]) -> None:
        """Top-(size-1) words by corpus frequency after ``<start>``, with
        log-normalized frequencies (shrinks when the corpus is smaller)."""
        word_counts: Dict[str, float] = {}
        for sentence in sentences:
            for w in tokenize(sentence):
                word_counts[w] = word_counts.get(w, 0) + 1.0
        if self.size - 1 > len(word_counts):
            self.size = len(word_counts) + 1
        self.words = ["<start>"]
        self.word2idx = {"<start>": 0}
        freqs = [1.0]
        ranked = sorted(word_counts.items(), key=lambda kv: kv[1], reverse=True)
        for idx in range(self.size - 1):
            word, frequency = ranked[idx]
            self.words.append(word)
            self.word2idx[word] = idx + 1
            freqs.append(frequency)
        f = np.array(freqs, dtype=np.float64)
        f /= f.sum()
        f = np.log(f)
        f -= f.max()
        self.word_frequencies = f

    def get_sentence(self, idxs: Sequence[int]) -> str:
        """Indices → detokenized sentence, truncated at the first '.'.
        Index 0 (``<start>``, doubling as pad) and out-of-range indices
        are never words, and a row with no words returns ""."""
        words: List[str] = []
        for i in idxs:
            i = int(i)
            if i <= 0 or i >= len(self.words):
                continue
            word = self.words[i]
            if word == ".":
                break
            words.append(word)
        if not words:
            return ""
        words.append(".")
        return "".join(
            " " + w if not w.startswith("'") and w not in string.punctuation else w
            for w in words
        ).strip()

    def save(self, save_file: str) -> None:
        """Atomic write in the JAX package's CSV layout."""
        d = os.path.dirname(save_file) or "."
        os.makedirs(d, exist_ok=True)
        tmp = f"{save_file}.{os.getpid()}.tmp"
        with open(tmp, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", "word", "index", "frequency"])
            for i, (word, freq) in enumerate(zip(self.words, self.word_frequencies)):
                w.writerow([i, word, i, repr(float(freq))])
        os.replace(tmp, save_file)

    def load(self, save_file: str) -> None:
        if not os.path.exists(save_file):
            raise FileNotFoundError(save_file)
        with open(save_file, newline="") as f:
            rows = list(csv.DictReader(f))
        n = min(self.size, len(rows))
        self.words = [str(r["word"]) for r in rows[:n]]
        self.word2idx = {w: i for i, w in enumerate(self.words)}
        self.word_frequencies = np.array(
            [float(r["frequency"]) for r in rows[:n]], np.float64
        )
        self.size = n
