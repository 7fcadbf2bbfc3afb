"""Preprocessed shard cache: mmap-backed host input pipeline — the port's
copy of ``sat_tpu.data.shards``, same on-disk format (either package
opens a cache the other built).

The post-resize uint8 image rows — the exact output of
``ImageLoader.load_raw``, so a cached row is bitwise the live decode's
by construction — are written once into ``.npy`` shard files and read
back through ``np.memmap``, turning batch assembly into a fancy-index
gather that touches no JPEG codec.

Layout of a cache directory::

    <cache_dir>/
      manifest.json        # fingerprint, shard list, file -> (shard, row)
      shard-00000.npy      # uint8 [rows, S, S, 3], a real .npy file
      shard-00000.crc.npy  # uint32 per-row crc32c sidecar (data.integrity)
      ...

The manifest records a **preprocessing fingerprint** (resize edge +
pipeline version): a cache built under a different ``image_size`` or an
older preprocessing algorithm is rejected at open time
(:class:`ShardCacheMismatch`), never silently served.  A content hash
over the manifest body catches truncated/hand-edited manifests, and each
shard's byte size is verified against its recorded row count.

Shards are **append-only**: re-building over a file list that grew (e.g.
the eval split after the train split) appends new shard files for the
missing images and rewrites only the manifest; existing shard bytes are
never touched.  Lookup misses fall back to live decode per image, so a
partially built cache degrades instead of failing the run
(``Config.shard_cache="auto"`` semantics — see ``resolve_shard_cache``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..resilience.faultinject import FaultPlan
from ..resilience.retry import retry_io
from .. import telemetry
from .integrity import crc32c_rows, write_row_crcs
from ..utils.fileio import atomic_write, read_text

MANIFEST_NAME = "manifest.json"
# Bump when the host preprocessing pipeline changes in any way that can
# alter stored bytes (decoder, channel order, resize interpolation):
# caches written by an older pipeline must stop validating.
PREPROCESS_VERSION = 1


class ShardCacheMismatch(RuntimeError):
    """The on-disk cache does not match the requested preprocessing (or is
    torn/corrupt) — callers either fall back to live decode or rebuild."""


def preprocess_fingerprint(image_size: int) -> Dict[str, object]:
    """Identity of the host preprocessing stage whose output shards hold.

    Matches ``ImageLoader.load_raw`` exactly: cv2 JPEG decode, BGR->RGB
    axis flip, cv2.resize to (S, S), uint8.  The mean subtraction is
    deliberately NOT part of the fingerprint — shards store the pre-mean
    uint8 tensor, so one cache serves both ``device_preprocess`` modes
    (the float32 - mean step is applied at gather time when the loader
    runs raw=False, bitwise-identical to the per-image live path).
    """
    return {
        "version": PREPROCESS_VERSION,
        "image_size": int(image_size),
        "layout": "uint8_rgb_hwc",
        "pipeline": "cv2.imread|BGR->RGB|cv2.resize(S,S)",
    }


def _manifest_hash(manifest: Dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "content_hash"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _key(image_file: str) -> str:
    """Manifest key for an image path.  Absolute + normalized so the same
    file reached through different relative spellings hits one row."""
    return os.path.normpath(os.path.abspath(str(image_file)))


class ShardCache:
    """Read side: memmap the shards, gather batches by file path.

    Shard memmaps are opened lazily and kept for the cache's lifetime —
    the OS page cache makes repeated gathers of a hot working set
    allocation-free on the read path.
    """

    def __init__(self, cache_dir: str, manifest: Dict):
        self.cache_dir = cache_dir
        self.manifest = manifest
        self.image_size = int(manifest["fingerprint"]["image_size"])
        self._entries: Dict[str, List[int]] = manifest["entries"]
        self._shard_files: List[str] = [s["file"] for s in manifest["shards"]]
        self._mmaps: List[Optional[np.memmap]] = [None] * len(self._shard_files)
        self.integrity = None  # see enable_integrity / data.integrity

    def enable_integrity(self, mode: str) -> None:
        """Arm per-row crc verification on gather (``--verify_shards``)."""
        from .integrity import ShardIntegrity

        self.integrity = (
            None if mode in (None, "", "off") else ShardIntegrity(self, mode)
        )

    # -- open/validate -----------------------------------------------------

    @classmethod
    def open(cls, cache_dir: str, image_size: int) -> "ShardCache":
        """Validate and open a cache for the given preprocessing.

        Raises FileNotFoundError when no manifest exists, and
        :class:`ShardCacheMismatch` when the manifest is torn, its
        fingerprint names a different preprocessing, or a shard file is
        missing/short.
        """
        path = os.path.join(cache_dir, MANIFEST_NAME)
        # retrying read: a flaky mount costs a backoff, not the cache
        # (FileNotFoundError stays fatal-immediate -> "no cache here")
        raw = read_text(path, desc=f"read shard manifest {path}")
        try:
            manifest = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ShardCacheMismatch(f"torn manifest {path}: {e}") from e
        if manifest.get("content_hash") != _manifest_hash(manifest):
            raise ShardCacheMismatch(
                f"{path}: content hash mismatch (truncated or hand-edited)"
            )
        want = preprocess_fingerprint(image_size)
        got = manifest.get("fingerprint")
        if got != want:
            raise ShardCacheMismatch(
                f"{cache_dir}: preprocessing fingerprint mismatch "
                f"(cache {got}, run wants {want}) — rebuild or fall back "
                "to live decode"
            )
        S = int(want["image_size"])
        row_bytes = S * S * 3
        for s in manifest["shards"]:
            sp = os.path.join(cache_dir, s["file"])
            if not os.path.exists(sp):
                raise ShardCacheMismatch(f"missing shard file {sp}")
            # header-inclusive lower bound: a truncated shard can't cover
            # its recorded rows (exact header size varies with the dict)
            if os.path.getsize(sp) < s["rows"] * row_bytes:
                raise ShardCacheMismatch(
                    f"short shard file {sp} for {s['rows']} recorded rows"
                )
        return cls(cache_dir, manifest)

    # -- lookup ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, image_file: str) -> bool:
        return _key(image_file) in self._entries

    def missing(self, image_files: Sequence[str]) -> List[str]:
        """Unique files (original spelling, first-seen order) not cached."""
        seen: Dict[str, str] = {}
        for f in image_files:
            k = _key(f)
            if k not in self._entries and k not in seen:
                seen[k] = str(f)
        return list(seen.values())

    def _shard(self, idx: int) -> np.memmap:
        mm = self._mmaps[idx]
        if mm is None:
            path = os.path.join(self.cache_dir, self._shard_files[idx])
            mm = retry_io(
                lambda: np.load(path, mmap_mode="r"),
                desc=f"mmap shard {path}",
            )
            self._mmaps[idx] = mm
        return mm

    # -- gather ------------------------------------------------------------

    def gather(
        self,
        image_files: Sequence[str],
        fallback: Optional[Callable[[str], np.ndarray]] = None,
        bad_rows: Optional[List[Tuple[int, str, str, Optional[BaseException]]]] = None,
    ) -> np.ndarray:
        """Assemble a uint8 [B, S, S, 3] batch for ``image_files``.

        Rows are grouped by shard and copied with ONE fancy-index read per
        shard per batch — no JPEG codec.  The batch is a fresh array that
        owns its bytes (fancy indexing copies out of the memmap), so it
        may be pinned or handed to ``torch.from_numpy``.  Files
        absent from the manifest — and, when integrity verification is
        armed (``enable_integrity``), rows failing their sidecar crc —
        go through ``fallback(file) -> uint8 row`` (live decode).

        ``bad_rows`` opts into containment: rows that could not be
        assembled at all (no fallback, or the fallback itself failed)
        are zero-filled and reported as ``(index, file, reason, exc)``
        tuples for the caller to quarantine.  Without it, failures
        raise (KeyError on a miss with no fallback, the decode error
        otherwise) so a mis-wired cache can't silently emit garbage.
        """
        with telemetry.span("data/shard_gather"):
            S = self.image_size
            out = np.empty((len(image_files), S, S, 3), np.uint8)
            by_shard: Dict[int, List[int]] = {}
            rows: List[int] = [0] * len(image_files)
            retry: List[Tuple[int, str]] = []
            for i, f in enumerate(image_files):
                entry = self._entries.get(_key(f))
                if entry is None:
                    retry.append((i, "cache_miss"))
                    continue
                by_shard.setdefault(entry[0], []).append(i)
                rows[i] = entry[1]
            for shard_idx, positions in by_shard.items():
                mm = self._shard(shard_idx)
                row_ids = [rows[i] for i in positions]
                out[positions] = mm[row_ids]
                if self.integrity is not None:
                    for local in self.integrity.verify_gather(
                        shard_idx, row_ids, out[positions]
                    ):
                        retry.append((positions[local], "crc_mismatch"))
            if retry:
                if fallback is None and bad_rows is None:
                    raise KeyError(
                        f"{len(retry)} image(s) not in shard cache "
                        f"{self.cache_dir} ({retry[0][1]}) and no "
                        f"live-decode fallback given "
                        f"(first: {image_files[retry[0][0]]!r})"
                    )
                fell_back = 0
                for i, reason in retry:
                    f = str(image_files[i])
                    if fallback is None:
                        bad_rows.append((i, f, reason, None))
                        out[i] = 0
                        continue
                    try:
                        out[i] = fallback(f)
                        fell_back += 1
                    except Exception as e:
                        if bad_rows is None:
                            raise
                        bad_rows.append(
                            (i, f, reason + "+live_decode_failed", e)
                        )
                        out[i] = 0
                if fell_back:
                    telemetry.count("data/decode_fallback", fell_back)
            return out


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------


def build_shard_cache(
    image_files: Sequence[str],
    cache_dir: str,
    image_size: int,
    rows_per_shard: int = 1024,
    loader=None,
    progress: bool = False,
) -> ShardCache:
    """Materialize (or extend) the shard cache for ``image_files``.

    Append-only: when a valid manifest already exists for this
    preprocessing, only the files it lacks are decoded, into NEW shard
    files numbered after the existing ones; the manifest is then rewritten
    atomically (tmp + rename), so a reader holding the old manifest keeps
    seeing a consistent cache and a crash mid-build leaves the previous
    manifest intact.  Shard files are written to a ``.tmp`` path and
    renamed into place only once fully flushed.
    """
    from .images import ImageLoader

    if loader is None:
        loader = ImageLoader(size=image_size, raw=True)
    os.makedirs(cache_dir, exist_ok=True)

    try:
        existing = ShardCache.open(cache_dir, image_size)
        entries = dict(existing._entries)
        shards = list(existing.manifest["shards"])
        todo = existing.missing(image_files)
    except FileNotFoundError:
        entries, shards = {}, []
        seen: Dict[str, str] = {}
        for f in image_files:  # dedupe: train lists repeat files per caption
            seen.setdefault(_key(f), str(f))
        todo = list(seen.values())
    # ShardCacheMismatch propagates: the caller asked to build into a dir
    # holding a DIFFERENT preprocessing's shards — overwriting or mixing
    # would corrupt whoever keyed on that dir; delete it explicitly.

    if not todo:
        return ShardCache.open(cache_dir, image_size)

    bar = None
    if progress:
        from ..utils.progress import Progress

        bar = Progress(len(todo), desc="shard cache")

    S = int(image_size)
    done = 0
    while done < len(todo):
        chunk = todo[done : done + rows_per_shard]
        shard_idx = len(shards)
        name = f"shard-{shard_idx:05d}.npy"
        tmp = os.path.join(cache_dir, name + ".tmp")
        mm = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.uint8, shape=(len(chunk), S, S, 3)
        )
        try:
            for row, f in enumerate(chunk):
                mm[row] = loader.load_raw(f)
                entries[_key(f)] = [shard_idx, row]
                if bar:
                    bar.update()
            mm.flush()
        except BaseException:
            del mm
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        del mm  # close before rename (flushes remaining dirty pages)
        os.replace(tmp, os.path.join(cache_dir, name))
        # per-row crc32c sidecar, computed from the landed bytes so it
        # attests what readers will actually mmap (data.integrity)
        write_row_crcs(
            os.path.join(cache_dir, name),
            crc32c_rows(
                np.asarray(np.load(os.path.join(cache_dir, name), mmap_mode="r"))
            ),
        )
        shards.append(
            {
                "file": name,
                "rows": len(chunk),
                "sha256": _file_sha256(os.path.join(cache_dir, name)),
            }
        )
        done += len(chunk)
    if bar:
        bar.close()

    manifest = {
        "format": 1,
        "fingerprint": preprocess_fingerprint(image_size),
        "dtype": "uint8",
        "row_shape": [S, S, 3],
        "shards": shards,
        "entries": entries,
    }
    manifest["content_hash"] = _manifest_hash(manifest)
    atomic_write(
        os.path.join(cache_dir, MANIFEST_NAME),
        "w",
        lambda f: json.dump(manifest, f),
    )
    return ShardCache(cache_dir, manifest)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# config wiring
# ---------------------------------------------------------------------------


def cache_dir_for(config) -> str:
    """One cache directory per preprocessing identity under
    ``config.shard_cache_dir`` — train/eval/test splits SHARE it (entries
    are keyed by absolute file path; shards append), while an
    ``image_size`` or pipeline-version change lands in a sibling dir so
    stale bytes are never even opened."""
    return os.path.join(
        config.shard_cache_dir,
        f"r{int(config.image_size)}-v{PREPROCESS_VERSION}",
    )


def resolve_shard_cache(config, image_files: Sequence[str]):
    """Build-or-load the shard cache per ``config.shard_cache``.

    * ``"off"``  -> None (always live decode);
    * ``"auto"`` -> use an existing valid cache, else None — a missing,
      torn, or wrong-fingerprint cache silently falls back to live decode
      (the manifest fingerprint is the invalidation mechanism);
    * ``"on"``   -> build/extend the cache to cover ``image_files`` first
      (one-time decode cost), then serve from it.

    Never raises for a missing cache; "on" propagates build errors (a
    build that can't read its images is a real failure) and the
    fingerprint-mismatch error (mixing preprocessings in one dir).
    """
    mode = config.shard_cache
    if mode == "off" or not config.shard_cache_dir:
        return None
    cache_dir = cache_dir_for(config)
    try:
        cache = ShardCache.open(cache_dir, config.image_size)
    except FileNotFoundError:
        cache = None
    except ShardCacheMismatch as e:
        if mode == "on":
            raise
        print(f"shard cache ignored: {e}")
        return None
    if mode == "on":
        cache = build_shard_cache(
            image_files,
            cache_dir,
            config.image_size,
            rows_per_shard=config.shard_rows,
            progress=True,
        )
    if cache is not None:
        # fault point: rot a shard row AFTER build wrote the sidecars,
        # so --verify_shards has something real to catch (idempotent —
        # the train and eval loaders both resolve)
        FaultPlan.from_env().maybe_corrupt_shard_row(cache_dir)
        cache.enable_integrity(getattr(config, "verify_shards", "off"))
        uniq = {_key(f) for f in image_files}
        hits = sum(1 for k in uniq if k in cache._entries)
        print(
            f"shard cache: {hits}/{len(uniq)} images served from "
            f"{cache_dir} ({len(uniq) - hits} live-decode fallback)"
        )
    return cache
