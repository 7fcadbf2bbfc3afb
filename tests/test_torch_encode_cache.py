"""The port's encode cache held to sat_tpu's on the CPU: the same plans
(rows, hits, misses, coalesced, evictions) for one seeded key sequence,
the ring's insert and gather bitwise with pad positions kept off real
rows, and, end to end on one float32 checkpoint, a hit bitwise its miss,
cache on and off and sat_tpu all giving the same words, one miss for a
concurrent burst of one image, and the flush on promote and rollback."""

import threading

import numpy as np
import pytest
import torch

from sat_tpu_torch.serve.encode_cache import EncodeCache
from tests.torch_planes_helpers import (
    beams, boot, both_servers, caption, close_beams, get_json, port_engine, registries, words, world,
)

torch.set_num_threads(2)

ROW = (4, 8)


def _pair(min_rows=3):
    from sat_tpu.serve.encode_cache import EncodeCache as JaxCache

    caches = {"torch": EncodeCache(0), "jax": JaxCache(0)}
    for cache in caches.values():
        cache.ensure_store(ROW, np.float32, min_rows=min_rows)
        cache.warm((1, 2, 4))
    return caches


def test_plans_match_jax_over_a_seeded_key_sequence():
    """500 keys (a Zipf-like draw over 40 images and two generations) in
    chunks of 1-4, with a failed dispatch's ``drop`` now and then and two
    flushes: every plan's rows, hits, misses and coalesced, and the
    lifetime counters, are sat_tpu's."""
    rng = np.random.default_rng(7)
    keys = [(int(k), int(g)) for k, g in zip(rng.zipf(1.3, 500) % 40, rng.integers(0, 2, 500))]
    caches = _pair(min_rows=4)
    pos = 0
    while pos < len(keys):
        n = int(rng.integers(1, 5))
        chunk = keys[pos:pos + n]
        pos += n
        plans = {name: cache.plan(chunk) for name, cache in caches.items()}
        got = [(p.rows, p.miss_keys, p.miss_rows, p.miss_pos, p.hits, p.coalesced) for p in plans.values()]
        assert got[0] == got[1], chunk
        if rng.random() < 0.1:
            for name, cache in caches.items():
                cache.drop(plans[name].miss_keys)
        if pos in (200, 400) or (pos > 200 and pos - n < 200):
            for cache in caches.values():
                cache.flush()
    stats = {name: cache.stats() for name, cache in caches.items()}
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["evictions"] > 0 and stats["torch"]["coalesced"] > 0 and stats["torch"]["flushes"] >= 1


def test_ring_insert_gather_bitwise_and_pads_stay_off_real_rows():
    """``insert`` then ``gather`` returns the inserted rows bitwise; pad
    positions of a lane write only the scratch row, and a gather's pad
    positions read it, so a real row never sees a pad."""
    cache = EncodeCache(0)
    cache.ensure_store(ROW, np.float32, min_rows=3)
    assert cache.rows == 4 and tuple(cache._store.shape) == (5,) + ROW
    rng = np.random.default_rng(0)
    first = torch.from_numpy(rng.standard_normal((4,) + ROW).astype(np.float32))
    cache.insert(4, first, [0, 1, 2, 3])
    lane = torch.from_numpy(rng.standard_normal((4,) + ROW).astype(np.float32))
    cache.insert(4, lane, [2])  # positions 1-3 are pads
    got = cache.gather(4, [2, 0])
    assert torch.equal(got[0], lane[0]) and torch.equal(got[1], first[0])
    assert torch.equal(cache.gather(2, [1, 3]), first[[1, 3]])  # untouched by the pads
    assert torch.equal(got[2], cache._store[cache.rows]) and torch.equal(got[3], got[2])
    assert any(torch.equal(cache._store[cache.rows], lane[j]) for j in (1, 2, 3))
    assert cache.inserts == 5 and cache.warm_widths == ()


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    return world(tmp_path_factory.mktemp("encode_cache"), encode_cache="on", encode_cache_mb=4)


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_hit_is_bitwise_its_miss_and_matches_jax(cached, tmp_path, mode):
    """Each image sent twice to the port's cached server: the second is a
    hit, bitwise the first; the port with the cache off and sat_tpu with
    it on give the same words (log-probs within 1e-5); the /stats cache
    blocks have sat_tpu's keys and its counts."""
    tc = cached["tc"].replace(serve_mode=mode, telemetry_dir=str(tmp_path / "t"))
    jc = cached["jc"].replace(serve_mode=mode, telemetry_dir=str(tmp_path / "j"))
    order = [0, 1, 0, 2, 1, 0]
    with both_servers(jc, tc) as servers:
        replies = {name: [caption(s.port, cached["jpegs"][i])[1] for i in order] for name, s in servers.items()}
        stats = {name: get_json(s.port, "/stats")[1] for name, s in servers.items()}
    with registries():
        off_cfg = tc.replace(encode_cache="off")
        off = boot("torch", off_cfg, port_engine(off_cfg))
        try:
            replies["off"] = [caption(off.port, cached["jpegs"][i])[1] for i in order]
            assert "encode_cache" not in get_json(off.port, "/stats")[1]
        finally:
            off.shutdown()
    first = {}
    for i, reply in zip(order, replies["torch"]):
        assert beams(reply) == first.setdefault(i, beams(reply))  # a hit is bitwise its miss
    for ours, off, theirs in zip(replies["torch"], replies["off"], replies["jax"]):
        assert words(ours) == words(off)
        close_beams(ours, theirs)
    block, jblock = stats["torch"]["encode_cache"], stats["jax"]["encode_cache"]
    assert set(block) == set(jblock)
    for key in ("entries", "hits", "misses", "coalesced", "inserts", "hit_ratio", "rows", "warm_widths"):
        assert block[key] == jblock[key], key
    assert (block["hits"], block["misses"]) == (3, 3)
    assert block["warm_widths"] == [1, 2]


def test_burst_of_one_image_is_one_miss_and_promote_flushes(cached, tmp_path):
    """Four concurrent requests of one new image: one miss, the rest hits
    or coalesced.  Then a candidate staged and promoted flushes the cache
    (and so does a rollback), and the next request of the image misses:
    its key carries the new params' fingerprint."""
    tc = cached["tc"].replace(telemetry_dir=str(tmp_path / "t"))
    with registries():
        engine = port_engine(tc)
        server = boot("torch", tc, engine)
        try:
            cache = engine.encode_cache
            threads = [threading.Thread(target=caption, args=(server.port, cached["jpegs"][5])) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert (cache.misses, cache.hits + cache.coalesced) == (1, 3)
            flushes = cache.flushes
            params = engine.slot_variables()
            engine.install_candidate(params, params["decoder"], 9, "same params")
            assert engine.param_fingerprint("canary") != engine.param_fingerprint()
            engine.clear_candidate()
            engine.install_candidate(params, params["decoder"], 9, "same params")
            assert engine.promote_candidate() == 9
            assert cache.flushes == flushes + 2 and cache.stats()["entries"] == 0
            status, reply, _ = caption(server.port, cached["jpegs"][5])
            assert status == 200 and reply["model_step"] == 9 and cache.misses == 2
            # the capacity model reads the real cache beside its sketch
            assert server.capacity._cache is cache
        finally:
            server.shutdown()
