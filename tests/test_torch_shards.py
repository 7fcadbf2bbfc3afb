"""The port's input pipeline — shard cache, crc integrity, quarantine —
held against sat_tpu's on the CPU.

Images are the fixture's JPEGs at 32 px (``tests/fixtures.py``), copied
into each test's own directory, plus a file that is not a JPEG.  Both
packages must write byte-identical caches and open each other's; a
cached row must be bitwise the live decode; the four ``verify_shards``
modes and ``repair_shards`` must do the same thing to a rotted row; the
quarantine must write the same ledger lines (file, reason, kind, pos)
and substitute the same rows; and an eval over a split with one broken
JPEG must complete in both with the same results.json and ledger.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu.data import integrity as jax_integrity
from sat_tpu.data import shards as jax_shards
from sat_tpu.data.images import ImageLoader as JaxImageLoader
from sat_tpu.data.images import PrefetchLoader as JaxPrefetchLoader
from sat_tpu.resilience.quarantine import QuarantineManager as JaxQuarantineManager
from sat_tpu.resilience.quarantine import SystemicCorruption as JaxSystemicCorruption
from sat_tpu.train.checkpoint import save_checkpoint
from sat_tpu_torch import cli, runtime
from sat_tpu_torch.data import integrity, shards
from sat_tpu_torch.data.dataset import build_vocabulary
from sat_tpu_torch.data.images import ImageLoader, PrefetchDecodeError, PrefetchLoader, walk_images
from sat_tpu_torch.resilience.faultinject import FaultPlan
from sat_tpu_torch.resilience.quarantine import QuarantineManager, SystemicCorruption
from tests.torch_port_helpers import configs

torch.set_num_threads(2)

SIZE = 32
BROKEN = "broken.jpg"
LEDGER_KEYS = ("file", "reason", "kind", "pos", "sha", "error")


@pytest.fixture
def images(coco_fixture, tmp_path):
    """The fixture's 12 JPEGs copied under ``tmp_path`` (sorted paths)."""
    d = tmp_path / "images"
    shutil.copytree(coco_fixture["train_img_dir"], d)
    return walk_images(str(d))


def broken_file(directory) -> str:
    path = os.path.join(str(directory), BROKEN)
    with open(path, "wb") as f:
        f.write(b"not a jpeg")
    return path


def ledger(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [{k: e.get(k) for k in LEDGER_KEYS} for e in map(json.loads, f)]


def tree_bytes(root):
    return {
        os.path.relpath(os.path.join(d, n), root): open(os.path.join(d, n), "rb").read()
        for d, _, names in os.walk(root) for n in names
    }


def test_crc32c_rows_equals_jax():
    rng = np.random.default_rng(0)
    for shape in ((5, 32, 32, 3), (3, 64, 64, 3), (4, 7), (0, 8)):
        rows = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(integrity.crc32c_rows(rows), jax_integrity.crc32c_rows(rows))


def test_caches_are_byte_identical_and_interchangeable(images, tmp_path):
    """Each package builds a cache over the same images: the same bytes in
    every file (manifest, shards, crc sidecars); each opens the other's,
    and a gathered row is bitwise the live decode of either package."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    shards.build_shard_cache(images, port_dir, SIZE, rows_per_shard=5)
    jax_shards.build_shard_cache(images, jax_dir, SIZE, rows_per_shard=5)
    assert tree_bytes(port_dir) == tree_bytes(jax_dir)
    assert sorted(tree_bytes(port_dir)) == sorted(
        [f"shard-0000{i}{ext}" for i in range(3) for ext in (".npy", ".crc.npy")] + ["manifest.json"])
    order = images[::-1]
    live = ImageLoader(SIZE).load_images(order)
    np.testing.assert_array_equal(live, JaxImageLoader(size=SIZE, raw=True).load_images(order))
    np.testing.assert_array_equal(shards.ShardCache.open(jax_dir, SIZE).gather(order), live)
    np.testing.assert_array_equal(jax_shards.ShardCache.open(port_dir, SIZE).gather(order), live)
    # append-only: a grown file list adds a shard, the old bytes untouched
    before = tree_bytes(port_dir)
    extra = str(tmp_path / "extra.jpg")
    shutil.copy(images[0], extra)
    cache = shards.build_shard_cache(images + [extra], port_dir, SIZE, rows_per_shard=5)
    after = tree_bytes(port_dir)
    assert {k: after[k] for k in before if k != "manifest.json"} == {
        k: v for k, v in before.items() if k != "manifest.json"}
    assert "shard-00003.npy" in after and len(cache) == 13


def test_shard_cache_refuses_another_preprocessing(images, tmp_path):
    cache_dir = str(tmp_path / "c")
    shards.build_shard_cache(images[:2], cache_dir, SIZE)
    with pytest.raises(shards.ShardCacheMismatch, match="fingerprint"):
        shards.ShardCache.open(cache_dir, 64)
    with pytest.raises(FileNotFoundError):
        shards.ShardCache.open(str(tmp_path / "none"), SIZE)


@pytest.mark.parametrize("mode", integrity.VERIFY_MODES)
def test_verify_modes_match_jax_on_a_rotted_row(images, tmp_path, mode):
    """Row 2 of shard 0 rotted after the build (``SAT_FI_CORRUPT_SHARD_ROW``):
    17 gathers in each package, ``off`` serving the rot, ``sample``
    catching it when its rotating row lands on it, ``open`` and ``full``
    replacing it with the live decode — the same rows in both."""
    cache_dir = str(tmp_path / "c")
    shards.build_shard_cache(images, cache_dir, SIZE, rows_per_shard=5)
    FaultPlan.from_env({"SAT_FI_CORRUPT_SHARD_ROW": "2"}).maybe_corrupt_shard_row(cache_dir)
    port, jaxc = shards.ShardCache.open(cache_dir, SIZE), jax_shards.ShardCache.open(cache_dir, SIZE)
    port.enable_integrity(mode)
    jaxc.enable_integrity(mode)
    loader, jloader = ImageLoader(SIZE), JaxImageLoader(size=SIZE, raw=True)
    live = loader.load_images(images[:5])
    for call in range(17):
        batch = images[:5] if call % 2 == 0 else images[2:7]
        got = port.gather(batch, fallback=loader.load_raw)
        want = jaxc.gather(batch, fallback=jloader.load_raw)
        np.testing.assert_array_equal(got, want, err_msg=f"gather {call}")
    rotted = port.gather(images[:5], fallback=loader.load_raw)
    if mode in ("open", "full"):
        np.testing.assert_array_equal(rotted, live)
    elif mode == "off":
        assert not np.array_equal(rotted[2], live[2])
        np.testing.assert_array_equal(np.delete(rotted, 2, 0), np.delete(live, 2, 0))


def test_repair_shards_matches_jax(images, tmp_path, capsys):
    """A rotted row and a quarantined file: ``repair_shards`` rebuilds the
    two shards that hold them and nothing else, in both packages, to the
    bytes of a clean build; the CLI prints the report (exit 0), or exits 2
    with no cache."""
    clean = str(tmp_path / "clean")
    shards.build_shard_cache(images, clean, SIZE, rows_per_shard=5)
    reports, trees = {}, {}
    for pkg in ("port", "jax"):
        jc, tc = configs(shard_cache_dir=str(tmp_path / pkg), quarantine_ledger=str(tmp_path / f"{pkg}.jsonl"))
        cache_dir = shards.cache_dir_for(tc)
        shutil.copytree(clean, cache_dir)
        FaultPlan.from_env({"SAT_FI_CORRUPT_SHARD_ROW": "2"}).maybe_corrupt_shard_row(cache_dir)
        QuarantineManager(tc.quarantine_ledger).quarantine(images[7], "decode_failed")
        report = integrity.repair_shards(tc) if pkg == "port" else jax_integrity.repair_shards(jc)
        reports[pkg] = {k: v for k, v in report.items() if k != "cache_dir"}
        trees[pkg] = tree_bytes(cache_dir)
    assert reports["port"] == reports["jax"]
    assert reports["port"]["shards_rebuilt"] == 2 and reports["port"]["rows_rebuilt"] == 10
    assert [s["shard"] for s in reports["port"]["suspect_shards"]] == ["shard-00000.npy", "shard-00001.npy"]
    assert trees["port"] == trees["jax"] == tree_bytes(clean)

    path = str(tmp_path / "repair.json")
    configs(shard_cache_dir=str(tmp_path / "port"), quarantine_ledger=str(tmp_path / "port.jsonl"))[1].save(path)
    capsys.readouterr()
    assert cli.main(["--config", path, "--repair_shards"]) == 0
    # the ledger still names the quarantined file: its shard is rebuilt again
    assert json.loads(capsys.readouterr().out)["shards_rebuilt"] == 1
    assert cli.main(["--config", path, "--repair_shards", "--set", f"shard_cache_dir={tmp_path / 'none'}"]) == 2


def test_resolve_shard_cache_modes(images, tmp_path, capsys):
    """``off``: none; ``auto``: none until a valid cache exists, then that
    one; ``on``: build, with the rows bitwise the live decode's."""
    _, tc = configs(shard_cache_dir=str(tmp_path / "s"))
    assert shards.resolve_shard_cache(tc.replace(shard_cache="off"), images) is None
    assert shards.resolve_shard_cache(tc.replace(shard_cache="auto"), images) is None
    cache = shards.resolve_shard_cache(tc.replace(shard_cache="on"), images)
    np.testing.assert_array_equal(cache.gather(images), ImageLoader(SIZE).load_images(images))
    assert shards.resolve_shard_cache(tc.replace(shard_cache="auto"), images[:3]) is not None
    assert "3/3 images served" in capsys.readouterr().out


def caption_batch(files, seed=0):
    """A training batch: (files, word_idxs [B, 8], masks [B, 8]) with 3-6
    tokens a row.  The loader substitutes rows in these arrays in place."""
    rng = np.random.default_rng(seed)
    words = rng.integers(2, 50, (len(files), 8)).astype(np.int32)
    masks = np.zeros((len(files), 8), np.float32)
    for i, n in enumerate(rng.integers(3, 7, len(files))):
        masks[i, :n] = 1.0
    return list(files), words, masks


def both_loaders(batches, tmp_path, name, shard_dir=None, ledger_from=None):
    """The port's and the JAX package's PrefetchLoader over the same
    batches, each with its own quarantine (a copy of ``ledger_from`` when
    given); returns (port batches, jax batches, port ledger, jax ledger).
    Each loader gets its own copy of the batches (substitution writes into
    a batch's caption arrays)."""
    out = {}
    for pkg, Loader, Image, Manager in (
        ("port", PrefetchLoader, lambda: ImageLoader(SIZE), QuarantineManager),
        ("jax", JaxPrefetchLoader, lambda: JaxImageLoader(size=SIZE, raw=True), JaxQuarantineManager),
    ):
        path = str(tmp_path / f"{name}_{pkg}.jsonl")
        if ledger_from:
            shutil.copy(ledger_from, path)
        cache = None
        if shard_dir:
            cache = (shards if pkg == "port" else jax_shards).ShardCache.open(shard_dir, SIZE)
        copies = [tuple(np.copy(x) for x in b) if isinstance(b, tuple) else list(b) for b in batches]
        loader = Loader(copies, Image(), num_workers=2, shard_cache=cache, quarantine=Manager(path))
        out[pkg] = (list(loader), path)
    return out["port"][0], out["jax"][0], out["port"][1], out["jax"][1]


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        assert a["files"] == b["files"]
        for k in ("images", "word_idxs", "masks"):
            if k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("cached", [False, True], ids=["live", "shard_cache"])
def test_quarantine_substitutes_like_jax(images, tmp_path, cached):
    """Eval-like batches of files with one broken JPEG, and training
    batches with an all-OOV and an overlength caption: the same rows and
    the same ledger lines in both packages (through the shard cache the
    broken file is a cache miss whose live decode fails).  A replay from
    the ledger, after the broken file was repaired, is bitwise the
    first pass."""
    bad = broken_file(os.path.dirname(images[0]))
    shard_dir = None
    if cached:
        shard_dir = str(tmp_path / "cache")
        shards.build_shard_cache(images, shard_dir, SIZE, rows_per_shard=5)
    train = caption_batch(images[4:8])
    train[2][1] = 1.0   # row 1 fills the caption length: overlength
    train[2][3] = 0.0   # row 3 has no in-vocabulary word: all-OOV
    batches = [images[:3] + [bad], caption_batch(images[8:12], seed=1), train]
    got, want, port_ledger, jax_ledger = both_loaders(batches, tmp_path, "first", shard_dir)
    assert_same_batches(got, want)
    assert ledger(port_ledger) == ledger(jax_ledger)
    reasons = [(e["file"], e["reason"], e["kind"], e["pos"]) for e in ledger(port_ledger)]
    assert reasons == [
        (bad, "cache_miss+live_decode_failed" if cached else "decode_failed", "image", None),
        (images[5], "caption_overlength", "caption", [0, 2, 1]),
        (images[7], "caption_all_oov", "caption", [0, 2, 3]),
    ]
    assert got[0]["files"][3] in images[:3]
    np.testing.assert_array_equal(got[0]["images"][3], got[0]["images"][got[0]["files"].index(got[0]["files"][3])])

    shutil.copy(images[0], bad)
    replay, jreplay, *_ = both_loaders(batches, tmp_path, "replay", shard_dir, ledger_from=port_ledger)
    assert_same_batches(replay, got)
    assert_same_batches(jreplay, got)


def test_all_rows_bad_is_systemic_in_both(images, tmp_path):
    batch = caption_batch(images[:2])
    batch[2][:] = 0.0
    with pytest.raises(SystemicCorruption, match="no healthy row"):
        list(PrefetchLoader([batch], ImageLoader(SIZE), num_workers=1,
                            quarantine=QuarantineManager(str(tmp_path / "p.jsonl"))))
    with pytest.raises(JaxSystemicCorruption, match="no healthy row"):
        list(JaxPrefetchLoader([batch], JaxImageLoader(size=SIZE, raw=True), num_workers=1,
                               quarantine=JaxQuarantineManager(str(tmp_path / "j.jsonl"))))


def test_decode_fault_hook_fires_in_the_port(images, tmp_path, monkeypatch):
    """``SAT_FI_BAD_IMAGE_EVERY`` rots the same files in both packages'
    ``load_raw``; without a quarantine the port's loader still raises
    ``PrefetchDecodeError`` naming the file."""
    import zlib

    monkeypatch.setenv("SAT_FI_BAD_IMAGE_EVERY", "3")
    victims = [f for f in images if zlib.crc32(os.path.basename(f).encode()) % 3 == 0]
    assert victims
    for f in images:
        for load in (ImageLoader(SIZE).load_raw, JaxImageLoader(size=SIZE, raw=True).load_raw):
            if f in victims:
                with pytest.raises(ValueError, match="injected decode failure"):
                    load(f)
            else:
                load(f)
    with pytest.raises(PrefetchDecodeError, match=os.path.basename(victims[0])):
        list(PrefetchLoader([[victims[0]]], ImageLoader(SIZE), num_workers=1))


# -- eval with a broken JPEG: the repair -----------------------------------


@pytest.fixture(scope="module")
def eval_world(coco_fixture, tmp_path_factory):
    """An eval split of the fixture's 12 images plus one broken JPEG with
    two captions of its own; the small model's checkpoint (terminator bias
    lowered by 2), saved by the JAX package."""
    root = tmp_path_factory.mktemp("torch_shards_eval")
    image_dir = root / "images"
    shutil.copytree(coco_fixture["val_img_dir"], image_dir)
    broken_file(image_dir)
    with open(coco_fixture["val_json"]) as f:
        coco = json.load(f)
    clean = str(root / "clean.json")
    with open(clean, "w") as f:
        json.dump(coco, f)
    coco["images"].append({"id": 13, "file_name": BROKEN})
    coco["annotations"] += [{"id": 2000 + j, "image_id": 13, "caption": coco["annotations"][j]["caption"]}
                            for j in range(2)]
    with_broken = str(root / "with_broken.json")
    with open(with_broken, "w") as f:
        json.dump(coco, f)
    c = coco_fixture["config"]
    settings = dict(
        eval_image_dir=str(image_dir), eval_caption_file=with_broken, train_caption_file=c.train_caption_file,
        max_train_ann_num=None, max_eval_ann_num=None, vocabulary_file=str(root / "vocabulary.csv"),
        save_dir=str(root / "models"), batch_size=4, num_data_workers=2, max_caption_length=12,
        save_eval_result_as_image=False, shard_cache="off",
    )
    jc, tc = configs(**settings)
    vocab = build_vocabulary(tc)
    state = jax.jit(jrt.create_train_state, static_argnums=1)(jax.random.PRNGKey(0), jc)
    fc_2 = state.params["decoder"]["decode"]["fc_2"]
    fc_2 = {**fc_2, "bias": fc_2["bias"].at[vocab.word2idx["."]].add(-2.0)}
    decoder = {**state.params["decoder"], "decode": {**state.params["decoder"]["decode"], "fc_2": fc_2}}
    path = save_checkpoint(state._replace(params={**state.params, "decoder": decoder}), jc)
    return {"root": root, "jc": jc, "tc": tc, "path": path, "clean": clean}


def outputs_of(root, name):
    return dict(eval_result_file=str(root / f"{name}.json"), eval_result_dir=str(root / name),
                summary_dir=str(root / f"{name}_summary"))


def test_eval_over_a_broken_jpeg_completes_like_jax(eval_world):
    """The repair: with defaults the port's eval quarantines the broken
    JPEG and substitutes a healthy row of its batch, as the JAX package
    does (before, it raised ``PrefetchDecodeError``): the same
    results.json, scores and ledger line."""
    root = eval_world["root"]
    jc = eval_world["jc"].replace(**outputs_of(root, "jax"))
    tc = eval_world["tc"].replace(**outputs_of(root, "port"))
    jscores = jrt.evaluate(jc, model_file=eval_world["path"])
    tscores = runtime.evaluate(tc, model_file=eval_world["path"], device="cpu")
    with open(jc.eval_result_file) as f:
        jrows = json.load(f)
    with open(tc.eval_result_file) as f:
        trows = json.load(f)
    assert trows == jrows and len(trows) == 13
    for k in jscores:
        assert tscores[k] == pytest.approx(jscores[k], rel=0, abs=1e-6), k
    jl = ledger(os.path.join(jc.summary_dir, "quarantine.jsonl"))
    tl = ledger(os.path.join(tc.summary_dir, "quarantine.jsonl"))
    assert tl == jl and [(e["reason"], os.path.basename(e["file"])) for e in tl] == [("decode_failed", BROKEN)]


def test_eval_over_the_shard_cache_equals_the_live_eval(eval_world):
    """``shard_cache="on"`` builds the cache over the split and decodes
    from it: results.json bitwise the live run's."""
    root = eval_world["root"]
    runs = {}
    for mode in ("off", "on"):
        tc = eval_world["tc"].replace(
            eval_caption_file=eval_world["clean"], shard_cache=mode, shard_cache_dir=str(root / "shards"),
            **outputs_of(root, f"clean_{mode}"))
        runtime.evaluate(tc, model_file=eval_world["path"], device="cpu")
        with open(tc.eval_result_file, "rb") as f:
            runs[mode] = f.read()
    assert runs["on"] == runs["off"]
    assert os.path.exists(os.path.join(str(root / "shards"), "r32-v1", "manifest.json"))
