"""sat_tpu_torch.bulk — offline bulk captioning at dataset scale, the port
of ``sat_tpu.bulk``.

``--phase bulk`` streams an image corpus (directory tree or file list,
no captions required) through the slot pool's stepped decode and writes
sharded caption JSONL with an atomically updated resume manifest:

* **input** — corpus walk + shard planning (:mod:`.corpus`), with the
  shard cache, its crc32c row integrity and the quarantine ledger
  (``data.shards``, ``data.integrity``, ``resilience.quarantine``), so
  poison images are substituted, never fatal;
* **decode** — the serve engine and ``PagedSlotPool`` embedded headless,
  no HTTP (:mod:`.runner`);
* **output** — ``captions_<shard>.jsonl`` + crc32c sidecars with
  tmp+rename atomicity (:mod:`.writer`) and the ``bulk_manifest.json``
  resume frontier (:mod:`.manifest`): kill the job anywhere, relaunch,
  and completed shards are skipped, bitwise-identically.

The corpus, manifest and writer modules import neither torch nor the
serve stack; :mod:`.runner` does.
"""
