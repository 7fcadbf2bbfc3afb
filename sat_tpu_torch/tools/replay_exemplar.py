"""Replay a captured quality exemplar through a freshly booted engine.

The port of ``scripts/replay_exemplar.py``.  The exemplar flight recorder
(``telemetry/exemplar.py``) stores, for each outlier request, the raw
image bytes plus the caption the serving stack produced, and a
``meta.json`` saying which model produced it (the config snapshot, the
checkpoint step, the vocabulary fingerprint).  This tool boots the same
engine headless (no HTTP, no batcher), pushes the stored bytes back
through preprocess → encode → decode, and asserts the caption comes back
bitwise identical.

On the card the bf16 encode is not width invariant: one image's contexts
at batch widths 1, 4, 16 and 32 differ.  So a row replays in the geometry
it was captured in, which the port's recorder writes into each row
(``geometry``):

* batch mode — an encode and a search ``encode_width`` wide, the image at
  row ``encode_row``, zeros in the other rows;
* continuous mode — a slot pool of the config's geometry, the image
  encoded at row ``encode_row`` of a lane ``encode_width`` wide and
  seeded into slot ``pool_slot``, then stepped until that slot is done
  (the masked kernel, as the capture ran it).

A row without a geometry (recorded by ``sat_tpu``, or served from the
encode cache or a handoff grid) replays alone in the smallest bucket, as
the JAX script replays every row.

The verdict is the debugging fork for every captured outlier: a match
means the model really says that about this image; a mismatch means the
serving stack produced a caption the model alone does not reproduce.
Scores and alphas digests are reported, not asserted.

``--diff A B`` replays the exemplars through two checkpoints and reports
their caption divergence (``telemetry.quality.caption_divergence``, the
score the lifecycle canary gates on).

Usage:
  python -m sat_tpu_torch.tools.replay_exemplar --dir DIR                # newest exemplar
  python -m sat_tpu_torch.tools.replay_exemplar --dir DIR --index 3      # specific row
  python -m sat_tpu_torch.tools.replay_exemplar --dir DIR --request-id R # by trace id
  python -m sat_tpu_torch.tools.replay_exemplar --dir DIR --all          # every replayable row
  python -m sat_tpu_torch.tools.replay_exemplar --dir DIR --diff OLD.npz NEW.npz

It runs on the card unless ``SAT_TORCH_DEVICE=cpu`` asks for the CPU.

Exit codes: 0 replayed bitwise (or --diff ran), 1 caption mismatch,
2 usage / missing data (no meta, image evicted, checkpoint unloadable).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

# a stored image that is gone: missing data (exit 2), not a mismatch
MISSING = None


def log(msg: str) -> None:
    print(f"[replay_exemplar] {msg}", file=sys.stderr, flush=True)


class Replayer:
    """One warmed engine (and, on first need, one warmed slot pool of the
    config's geometry) that captions stored image bytes in a recorded
    geometry."""

    def __init__(self, config, model_file: Optional[str], device) -> None:
        from ..data.vocabulary import Vocabulary
        from ..serve.engine import ServeEngine, load_serving_state

        vocabulary = Vocabulary(config.vocabulary_size, config.vocabulary_file)
        state, source = load_serving_state(config, model_file=model_file, device=device)
        self.engine = ServeEngine(config, state, vocabulary, device=device)
        log(f"params from {source} (step {self.engine.step}); warming bucket ladder")
        self.engine.warmup()
        self._pool = None

    def _pool_for(self):
        if self._pool is None:
            from ..serve.slot_pool import PagedSlotPool

            self._pool = PagedSlotPool(self.engine)
            self._pool.warmup()
        return self._pool

    def _batch(self, row, width: int, index: int):
        import numpy as np

        engine = self.engine
        size = engine.config.image_size
        images = np.zeros((width, size, size, 3), engine._image_dtype)
        images[index] = row
        out = engine.dispatch(images)
        return tuple(None if a is None else a[index:index + 1] for a in engine.drain_output(out, index + 1))

    def _continuous(self, row, lane: int, index: int, slot: int):
        pool = self._pool_for()
        pool.admit_at(row, None, lane, index, slot)
        for _ in range(pool.max_len + 2):
            done = pool.multi_step(pool.decode_depths[0])[0].cpu().numpy()
            if done[slot]:
                _, words, lengths, scores, _, alphas = pool.harvest(done)
                return words, lengths, scores, alphas
        raise RuntimeError(f"slot {slot} did not finish in {pool.max_len + 2} decode steps")

    def caption(self, image_bytes: bytes, geometry: Optional[Dict] = None) -> Dict:
        """One headless request: bytes → {caption, beams, alphas_digest}."""
        from ..telemetry.exemplar import alphas_digest

        row = self.engine.preprocess(image_bytes)
        if geometry and geometry.get("mode") == "continuous":
            words, lengths, scores, alphas = self._continuous(
                row, int(geometry["encode_width"]), int(geometry["encode_row"]), int(geometry["pool_slot"]))
        elif geometry:
            words, lengths, scores, alphas = self._batch(
                row, int(geometry["encode_width"]), int(geometry["encode_row"]))
        else:
            words, lengths, scores, alphas = self._batch(row, self.engine.pick_bucket(1), 0)
        captions = self.engine.detok_rows((words, lengths, scores), 1)[0]["captions"]
        return {
            "caption": captions[0]["caption"],
            "beams": captions,
            "alphas_digest": alphas_digest(alphas[0]) if alphas is not None else None,
        }


def _pick_rows(rows: List[Dict], args) -> List[Dict]:
    replayable = [r for r in rows if r.get("image")]
    if args.request_id:
        picked = [r for r in replayable if r.get("request_id") == args.request_id]
        if not picked:
            log(f"no replayable exemplar with request_id={args.request_id!r}")
            sys.exit(2)
        return picked
    if args.index is not None:
        if not (0 <= args.index < len(rows)):
            log(f"--index {args.index} out of range (have {len(rows)} rows)")
            sys.exit(2)
        row = rows[args.index]
        if not row.get("image"):
            log(
                f"exemplar {args.index} has no stored image "
                f"(over the size cap or evicted; image_bytes="
                f"{row.get('image_bytes')})"
            )
            sys.exit(2)
        return [row]
    if args.all:
        return replayable
    if not replayable:
        log("no replayable exemplars (no rows with a stored image)")
        sys.exit(2)
    return [replayable[-1]]  # newest: rows arrive sorted by t_unix


def _replay_one(replayer: Replayer, dir: str, row: Dict) -> Optional[bool]:
    """Replay one exemplar: True when the caption matched bitwise, False
    on a mismatch, ``MISSING`` when its stored image is gone."""
    from ..telemetry.exemplar import load_image

    image = load_image(dir, row)
    if image is None:
        log(f"image {row.get('image')} missing (evicted?) — skipping")
        return MISSING
    got = replayer.caption(image, row.get("geometry"))
    want = row.get("caption", "")
    rid = row.get("request_id", "") or "<no id>"
    match = got["caption"] == want
    print(
        json.dumps(
            {
                "request_id": rid,
                "reasons": row.get("reasons", []),
                "verdict": "BITWISE MATCH" if match else "MISMATCH",
                "captured": want,
                "replayed": got["caption"],
                "geometry": row.get("geometry"),
                # informational: scores may legitimately differ (score-space
                # fault injection at capture time)
                "alphas_digest_captured": row.get("alphas_digest"),
                "alphas_digest_replayed": got["alphas_digest"],
            },
            sort_keys=True,
        ),
        flush=True,
    )
    return match


def _run_diff(config, rows: List[Dict], dir: str, files: List[str], device) -> int:
    from ..telemetry.exemplar import load_image
    from ..telemetry.quality import caption_divergence

    replayers = [Replayer(config, f, device) for f in files]
    for row in rows:
        image = load_image(dir, row)
        if image is None:
            log(f"image {row.get('image')} missing — skipping")
            continue
        a = replayers[0].caption(image, row.get("geometry"))["caption"]
        b = replayers[1].caption(image, row.get("geometry"))["caption"]
        print(
            json.dumps(
                {
                    "request_id": row.get("request_id", ""),
                    "captured": row.get("caption", ""),
                    "old": a,
                    "new": b,
                    "divergence": round(caption_divergence(a, b), 4),
                },
                sort_keys=True,
            ),
            flush=True,
        )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sat_tpu_torch.tools.replay_exemplar",
        description="Replay captured quality exemplars bitwise",
    )
    parser.add_argument("--dir", required=True, help="exemplar directory")
    parser.add_argument("--model", default=None, help="override checkpoint file")
    parser.add_argument("--index", type=int, default=None)
    parser.add_argument("--request-id", default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument(
        "--diff",
        nargs=2,
        metavar=("OLD", "NEW"),
        default=None,
        help="replay through two checkpoints and report caption divergence",
    )
    args = parser.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device()

    from ..config import Config
    from ..telemetry.exemplar import read_exemplars, read_meta
    from ..utils.summary import crc32c

    meta = read_meta(args.dir)
    if not meta or "config" not in meta:
        log(f"no usable meta.json in {args.dir} — cannot rebuild the engine")
        return 2
    config = Config.from_dict(meta["config"])
    rows, torn = read_exemplars(args.dir)
    if torn:
        log(f"skipped {torn} torn exemplar line(s)")
    if not rows:
        log("no exemplars recorded")
        return 2
    picked = _pick_rows(rows, args)

    if args.diff:
        return _run_diff(config, picked, args.dir, list(args.diff), device)

    replayer = Replayer(config, args.model, device)
    engine = replayer.engine
    want_crc = meta.get("vocab_crc32c")
    have_crc = "%08x" % crc32c("\n".join(engine.vocabulary.words).encode("utf-8"))
    if want_crc and want_crc != have_crc:
        log(
            f"vocabulary fingerprint mismatch (meta {want_crc} vs loaded "
            f"{have_crc}) — captions cannot replay bitwise"
        )
        return 2
    if meta.get("model_step") is not None and engine.step != meta["model_step"]:
        log(
            f"WARNING: replaying against step {engine.step}, exemplars were "
            f"captured at step {meta['model_step']} (pass --model to pin)"
        )
    results = [_replay_one(replayer, args.dir, row) for row in picked]
    ok = sum(1 for r in results if r is True)
    log(f"{ok}/{len(results)} exemplar(s) replayed bitwise")
    if any(r is False for r in results):
        return 1
    if not results or any(r is MISSING for r in results):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
