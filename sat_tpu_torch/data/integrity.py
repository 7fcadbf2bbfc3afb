"""Record-level shard integrity: crc32c sidecars, verify-on-gather, repair
— the port's copy of ``sat_tpu.data.integrity``, same sidecar format.

The shard cache (``data.shards``) turns batch assembly into mmap
fancy-indexing — and thereby inherits storage's failure modes: a torn
write or flipped bit in a shard row would be served to the model
silently.  This module is the detection half of the data plane's immune
system (``resilience.quarantine`` is the containment half):

* ``build_shard_cache`` writes a **per-row crc32c sidecar**
  (``shard-00000.crc.npy``, a uint32 array) next to every shard, using
  the vectorized Castagnoli crc of ``utils.summary``, batched here
  across rows;
* ``gather`` verifies rows against the sidecar per ``--verify_shards``:

  - ``off``    — nothing (default; trust the storage);
  - ``sample`` — one rotating row every :data:`SAMPLE_EVERY` gathers;
  - ``open``   — full verify of each shard the first time a gather
    touches it, cached bad-row set consulted thereafter;
  - ``full``   — every gathered row, every batch (audit mode);

* a detected-corrupt row is routed to the live-decode ``fallback``
  (the shard row IS the live path's post-resize uint8, so recovery is
  bitwise) and, failing that, quarantined;
* ``repair_shards`` (CLI ``--repair_shards``) rebuilds ONLY the shards
  holding crc-mismatching or ledger-quarantined rows, by re-decoding
  their source images in row order — bitwise-identical to a clean
  rebuild, without paying for one.

Sidecars are retrofitted lazily for caches built without them: the
first verification of such a shard computes and writes its sidecar from
the current bytes (the best available truth).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..utils.summary import (
    _CRC_TABLE_NP,
    _CRC_VECTOR_MIN,
    _ADV1,
    _crc32c_scalar,
    _gf2_matmul,
    _matvec_vec,
    crc32c,
)

CRC_SUFFIX = ".crc.npy"
VERIFY_MODES = ("off", "sample", "open", "full")
# sample mode verifies one row every this many gather calls, so its cost
# per batch is a sixteenth of one row's crc
SAMPLE_EVERY = 16


def sidecar_path(shard_path: str) -> str:
    base = shard_path[:-4] if shard_path.endswith(".npy") else shard_path
    return base + CRC_SUFFIX


# ---------------------------------------------------------------------------
# Batched crc32c: one pass over [N, L] uint8 rows -> uint32[N].
#
# utils.summary.crc32c vectorizes ONE payload across K interleaved
# lanes; calling it per row would pay its ~3 ms GF(2) stitch setup per
# row.  Here the identical lane scheme runs with an extra leading batch
# axis — the byte loop is lane_rows iterations over an [N, K] state
# array — and the stitch matrices are memoized per (K, lane_rows), so
# N rows cost one setup.  Bitwise-identical to summary.crc32c per row.
# ---------------------------------------------------------------------------

_STITCH_CACHE: Dict[Tuple[int, int], List[np.ndarray]] = {}


def _stitch_chain(K: int, lane_rows: int) -> List[np.ndarray]:
    """Zero-advance matrices for the halving stitch: level i advances a
    lane over ``lane_rows * 2**i`` bytes (advance-by-lane_rows, squared
    per level)."""
    key = (K, lane_rows)
    chain = _STITCH_CACHE.get(key)
    if chain is None:
        adv_span = None
        bit_m = _ADV1
        r = lane_rows
        while r:
            if r & 1:
                adv_span = (
                    bit_m if adv_span is None else _gf2_matmul(bit_m, adv_span)
                )
            r >>= 1
            if r:
                bit_m = _gf2_matmul(bit_m, bit_m)
        chain = []
        m = adv_span
        k = K
        while k > 1:
            chain.append(m)
            k //= 2
            if k > 1:
                m = _gf2_matmul(m, m)
        _STITCH_CACHE[key] = chain
    return chain


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """crc32c of each row of a [N, ...] uint8 array, vectorized across
    both the lane axis and the batch axis."""
    if len(rows) == 0:
        return np.empty(0, np.uint32)
    arr = np.ascontiguousarray(rows, dtype=np.uint8).reshape(len(rows), -1)
    N, L = arr.shape
    if L < _CRC_VECTOR_MIN:
        return np.array(
            [crc32c(arr[i].tobytes()) for i in range(N)], np.uint32
        )
    K = 1 << max(8, min(16, (L // 256).bit_length() - 1))
    lane_rows = L // K
    chunk = lane_rows * K
    # lane k of a row holds its CONTIGUOUS bytes [k*lane_rows, (k+1)*lane_rows)
    cols = arr[:, :chunk].reshape(N, K, lane_rows)
    states = np.zeros((N, K), np.uint32)
    states[:, 0] = 0xFFFFFFFF
    for j in range(lane_rows):
        states = _CRC_TABLE_NP[
            (states ^ cols[:, :, j]) & np.uint32(0xFF)
        ] ^ (states >> np.uint32(8))
    for m in _stitch_chain(K, lane_rows):
        left, right = states[:, 0::2], states[:, 1::2]
        states = _matvec_vec(m, left) ^ right
    crcs = states[:, 0]
    if chunk < L:
        out = np.empty(N, np.uint32)
        tail = arr[:, chunk:]
        for i in range(N):
            out[i] = _crc32c_scalar(tail[i].tobytes(), int(crcs[i])) ^ 0xFFFFFFFF
        return out
    return crcs ^ np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# sidecar IO
# ---------------------------------------------------------------------------


def write_row_crcs(shard_path: str, crcs: np.ndarray) -> str:
    """Atomic (tmp + rename) sidecar write; returns the sidecar path."""
    path = sidecar_path(shard_path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, np.asarray(crcs, np.uint32))
    os.replace(tmp, path)
    return path


def read_row_crcs(shard_path: str) -> Optional[np.ndarray]:
    """The sidecar's uint32 row crcs, or None when absent/unreadable."""
    path = sidecar_path(shard_path)
    try:
        return np.asarray(np.load(path), np.uint32)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# verify-on-gather
# ---------------------------------------------------------------------------


class ShardIntegrity:
    """Per-cache verification state, attached to a ``ShardCache`` by
    ``enable_integrity`` and consulted from ``gather``.  Returns the
    *local* indices (into the gathered row list) that fail their crc;
    the gather routes those through fallback/quarantine."""

    def __init__(self, cache, mode: str) -> None:
        if mode not in VERIFY_MODES:
            raise ValueError(
                f"verify_shards must be one of {VERIFY_MODES}, got {mode!r}"
            )
        self.cache = cache
        self.mode = mode
        self._crcs: Dict[int, np.ndarray] = {}
        self._bad_rows: Dict[int, set] = {}
        self._opened: set = set()
        self._calls = 0
        self._cursor = 0

    def crcs_for(self, shard_idx: int) -> np.ndarray:
        crcs = self._crcs.get(shard_idx)
        if crcs is None:
            shard_path = os.path.join(
                self.cache.cache_dir, self.cache._shard_files[shard_idx]
            )
            crcs = read_row_crcs(shard_path)
            if crcs is None:
                # legacy cache (pre-sidecar): retrofit from current bytes
                crcs = crc32c_rows(
                    np.asarray(self.cache._shard(shard_idx))
                )
                write_row_crcs(shard_path, crcs)
            self._crcs[shard_idx] = crcs
        return crcs

    def _check(
        self,
        shard_idx: int,
        row_ids: Sequence[int],
        gathered: np.ndarray,
        local: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Compare gathered rows (the bytes about to be trained on)
        against the sidecar; returns mismatching local indices."""
        crcs = self.crcs_for(shard_idx)
        if local is None:
            local = range(len(row_ids))
        local = [i for i in local if row_ids[i] < len(crcs)]
        if not local:
            return []
        want = crcs[[row_ids[i] for i in local]]
        got = crc32c_rows(gathered[list(local)])
        telemetry.count("data/verify_rows", len(local))
        bad = [local[j] for j in np.nonzero(got != want)[0]]
        if bad:
            telemetry.count("data/corrupt_rows", len(bad))
        return bad

    def verify_gather(
        self, shard_idx: int, row_ids: Sequence[int], gathered: np.ndarray
    ) -> List[int]:
        if self.mode == "off" or not len(row_ids):
            return []
        if self.mode == "full":
            return self._check(shard_idx, row_ids, gathered)
        if self.mode == "open":
            if shard_idx not in self._opened:
                self._opened.add(shard_idx)
                mm = self.cache._shard(shard_idx)
                whole = self._check(
                    shard_idx,
                    list(range(len(mm))),
                    np.asarray(mm),
                )
                self._bad_rows[shard_idx] = set(whole)
            bad = self._bad_rows.get(shard_idx, ())
            return [i for i, r in enumerate(row_ids) if r in bad]
        # sample: one deterministically rotating row every SAMPLE_EVERY
        # gather calls — a slow scrub that costs ~nothing per step
        self._calls += 1
        if self._calls % SAMPLE_EVERY:
            return []
        i = self._cursor % len(row_ids)
        self._cursor += 1
        return self._check(shard_idx, row_ids, gathered, [i])


# ---------------------------------------------------------------------------
# --repair_shards
# ---------------------------------------------------------------------------


def _ledger_files(ledger_path: str) -> set:
    """Normalized file paths of image-kind entries in a quarantine
    ledger (caption-kind entries are positional, not file rot)."""
    files = set()
    try:
        with open(ledger_path) as f:
            lines = f.readlines()
    except OSError:
        return files
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            entry = json.loads(line)
        except ValueError:
            continue
        if entry.get("kind") != "caption" and entry.get("file"):
            files.add(os.path.normpath(os.path.abspath(entry["file"])))
    return files


def repair_shards(config, loader=None) -> Dict:
    """Rebuild only the shards holding crc-mismatching or quarantined
    rows; returns a JSON-able report.  Touches no device (the CLI runs
    it before anything else).

    Raises FileNotFoundError when no cache exists for this config."""
    from ..resilience.quarantine import ledger_path_for
    from ..utils.fileio import atomic_write
    from .shards import (
        MANIFEST_NAME,
        ShardCache,
        _file_sha256,
        _manifest_hash,
        cache_dir_for,
    )

    cache_dir = cache_dir_for(config)
    cache = ShardCache.open(cache_dir, config.image_size)
    quarantined = _ledger_files(ledger_path_for(config))

    # reverse the manifest: shard -> [(row, file)] (entry keys ARE the
    # normalized absolute source paths)
    shard_rows: Dict[int, List[Tuple[int, str]]] = {}
    for key, (si, row) in cache._entries.items():
        shard_rows.setdefault(si, []).append((row, key))

    if loader is None:
        from .images import ImageLoader

        loader = ImageLoader(size=config.image_size, raw=True)

    report: Dict = {
        "cache_dir": cache_dir,
        "shards_total": len(cache._shard_files),
        "shards_rebuilt": 0,
        "rows_rebuilt": 0,
        "suspect_shards": [],
        "unrepairable": [],
    }
    manifest = cache.manifest
    for si, name in enumerate(cache._shard_files):
        shard_path = os.path.join(cache_dir, name)
        mm = cache._shard(si)
        data = np.asarray(mm)
        crcs = read_row_crcs(shard_path)
        if crcs is None:
            # no sidecar: the current bytes are the only truth — write
            # one so future corruption is at least detectable
            write_row_crcs(shard_path, crc32c_rows(data))
            crcs = read_row_crcs(shard_path)
        got = crc32c_rows(data)
        mismatches = sorted(int(r) for r in np.nonzero(got != crcs)[0])
        rows = sorted(shard_rows.get(si, []))
        quarantined_here = sorted(
            f for _, f in rows if f in quarantined
        )
        if not mismatches and not quarantined_here:
            continue
        report["suspect_shards"].append(
            {
                "shard": name,
                "crc_mismatch_rows": mismatches,
                "quarantined_files": quarantined_here,
            }
        )
        tmp = shard_path + ".repair.tmp"
        new = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.uint8, shape=mm.shape
        )
        try:
            for row, f in rows:
                try:
                    new[row] = loader.load_raw(f)
                    report["rows_rebuilt"] += 1
                except Exception as e:
                    # keep the old bytes: a source image that can't be
                    # re-decoded is the quarantine's problem, not a
                    # reason to lose the rest of the shard
                    new[row] = data[row]
                    report["unrepairable"].append(
                        {"file": f, "error": f"{type(e).__name__}: {e}"}
                    )
            new.flush()
        except BaseException:
            del new
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        del new
        cache._mmaps[si] = None  # drop the stale mmap before the swap
        os.replace(tmp, shard_path)
        write_row_crcs(
            shard_path,
            crc32c_rows(np.asarray(np.load(shard_path, mmap_mode="r"))),
        )
        manifest["shards"][si]["sha256"] = _file_sha256(shard_path)
        report["shards_rebuilt"] += 1
    if report["shards_rebuilt"]:
        manifest["content_hash"] = _manifest_hash(manifest)
        atomic_write(
            os.path.join(cache_dir, MANIFEST_NAME),
            "w",
            lambda f: json.dump(manifest, f),
        )
    return report
