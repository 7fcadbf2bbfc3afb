"""Corpus resolution and output-shard planning for ``--phase bulk`` — the
port's copy of ``sat_tpu.bulk.corpus``.

A bulk corpus is whatever the operator points ``--bulk_input`` at:

* a **directory** — recursively walked for image files
  (``data.images.walk_images``; non-image files are counted and
  skipped, not fatal);
* a **file list** — a regular text file, one image path per line
  (blank lines and ``#`` comments ignored), resolved relative to the
  list's own directory so a list ships alongside its corpus.

Both forms resolve to the same thing: an ordered list of absolute
paths.  The ORDER is the contract — the manifest fingerprint, the shard
plan, the quarantine substitution and therefore the bitwise-resume
guarantee all key off it — so both paths normalize and sort
deterministically, independent of filesystem iteration order.
"""

from __future__ import annotations

import os
from typing import List

from ..data.images import walk_images


class CorpusError(ValueError):
    """``--bulk_input`` does not resolve to a usable corpus (missing
    path, empty directory, empty list).  Configuration, not data: raised
    before any decode work starts, never quarantined."""


def resolve_corpus(bulk_input: str) -> List[str]:
    """Resolve ``--bulk_input`` to the ordered list of absolute image
    paths (see module docstring for the two accepted forms)."""
    if not bulk_input:
        raise CorpusError("--bulk_input is required for --phase bulk")
    path = os.path.abspath(bulk_input)
    if os.path.isdir(path):
        files = walk_images(path)
        if not files:
            raise CorpusError(f"no image files under directory {path!r}")
        return files
    if os.path.isfile(path):
        files = _read_file_list(path)
        if not files:
            raise CorpusError(f"file list {path!r} names no images")
        return files
    raise CorpusError(f"--bulk_input {path!r} is neither a directory nor a file")


def _read_file_list(list_path: str) -> List[str]:
    # retrying read (utils.fileio): the list often lives on the same
    # flaky shared mount as the corpus itself
    from ..utils.fileio import read_text

    base = os.path.dirname(list_path)
    files = []
    for line in read_text(list_path, desc=f"read corpus list {list_path}").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if not os.path.isabs(line):
            line = os.path.join(base, line)
        files.append(os.path.abspath(line))
    # de-dup preserving nothing subtle: sort is the corpus-order contract
    return sorted(set(files))


def plan_shards(files: List[str], rows_per_shard: int) -> List[List[str]]:
    """Split the ordered corpus into output-shard file lists: every shard
    holds ``rows_per_shard`` rows except the final remainder.

    The plan is a pure function of (corpus order, rows_per_shard) —
    never of device count, pool geometry or restart history — which is
    what makes resume elastic: a job killed on one machine and resumed on
    another re-derives the identical plan and only re-decodes shards
    without a completed, crc-verified output file.
    """
    if rows_per_shard < 1:
        raise ValueError(f"rows_per_shard must be >= 1, got {rows_per_shard}")
    return [files[i : i + rows_per_shard] for i in range(0, len(files), rows_per_shard)]
