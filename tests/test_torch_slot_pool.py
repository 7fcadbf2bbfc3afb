"""The port's stepped decode and paged slot pool held against sat_tpu's.

``decode_step`` and ``decode_multi_step`` run in lockstep with
``sat_tpu.ops.beam_search``'s on the same admissions: words, lengths,
per-slot ``t``, ``done`` and ``steps_run`` equal, log-scores and alphas
within the float32 summation-order tolerance of
``test_torch_beam_search.py``.  Then the port's own invariants, bitwise,
and ``PagedSlotPool``'s bookkeeping on a CPU engine.

The decoder's eos bias is raised a little (``EOS_BIAS``) so that some
captions seal after two or three steps and others run to the end: slots
then retire and are reseeded at different ticks.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.ops import pallas_attention
from sat_tpu_torch.ops import beam_search as bs
from sat_tpu_torch.serve.batcher import choose_decode_depth
from sat_tpu_torch.train.checkpoint import params_from_flat
from tests.torch_port_helpers import configs, flat_params, jax_variables, to_torch

# the ops package re-exports the beam_search function under the module's name
jbs = importlib.import_module("sat_tpu.ops.beam_search")

torch.set_num_threads(2)

EOS = 3
EOS_BIAS = 0.15
ATOL = 1e-5  # test_torch_beam_search.py's: float32 summation order


def _setup(B=5, seed=0, **kw):
    """(jax config, port config, jax decoder params, port decoder params,
    contexts [B, N, D]) with the same weights, eos bias raised."""
    jc, tc = configs(**kw)
    variables = jax_variables(jc, seed)
    dec = variables["params"]["decoder"]
    fc = dict(dec["decode"]["fc_2"], bias=dec["decode"]["fc_2"]["bias"].at[EOS].add(EOS_BIAS))
    jp = dict(dec, decode=dict(dec["decode"], fc_2=fc))
    flat = flat_params({"params": dict(variables["params"], decoder=jp)})
    tp = params_from_flat(flat, tc, "cpu")["decoder"]
    contexts = np.random.default_rng(seed).normal(size=(B, tc.num_ctx, tc.dim_ctx)).astype(np.float32)
    return jc, tc, jp, tp, contexts


def _jax_fns():
    """Freshly jitted JAX slot functions: a new trace, so a test that sets
    ``pallas_attention.FORCE_INTERPRET`` gets the Pallas masked body."""

    def seed(params, config, carry, lane_ctx, slot_src, admit_mask):
        return jbs.init_slots(params, config, carry, lane_ctx, slot_src, admit_mask)

    def step(params, config, carry, slot_mask, eos_id, valid_size=None):
        return jbs.decode_step(params, config, carry, slot_mask, eos_id, valid_size=valid_size)

    def multi(params, config, carry, slot_mask, eos_id, k, valid_size=None):
        return jbs.decode_multi_step(params, config, carry, slot_mask, eos_id, k, valid_size=valid_size)

    statics = ("config", "eos_id", "valid_size")
    return dict(
        seed=jax.jit(seed, static_argnames=("config",)),
        step=jax.jit(step, static_argnames=statics),
        multi=jax.jit(multi, static_argnames=statics),
        harvest=jax.jit(lambda c: jbs.harvest_slots(c, return_alphas=True)),
    )


_jax = functools.cache(_jax_fns)  # jitted once for the cases that share them


def _schedule(B, S, width, burst, admit_every):
    """The admission plan both packages follow: at each admitting tick,
    one request (staggered) or a page of up to ``width`` (bursty)."""
    free, nxt, tick = list(range(S)), 0, 0
    while True:
        seeds = []
        if free and nxt < B and tick % admit_every == 0:
            n = min(len(free), B - nxt, width if burst else 1)
            seeds = [(free.pop(0), nxt + j) for j in range(n)]
            nxt += n
        finished = yield seeds
        free.extend(finished)
        tick += 1


def _lockstep(jc, tc, jp, tp, contexts, *, pages=2, width=2, burst=False, admit_every=1,
              k=1, valid_size=None, fns=None):
    """Drive both pools tick by tick and compare after every tick.
    Returns the port's per-request (words, scores, lengths, alphas, steps)."""
    fns = fns or _jax()
    B, S = len(contexts), pages * width
    jcarry = jbs.init_slot_pool(jc, slots=S, return_alphas=True)
    tcarry = bs.init_slot_pool(tc, S, return_alphas=True)
    plan = _schedule(B, S, width, burst, admit_every)
    seeds = next(plan)
    binding, results, ticks = {}, {}, 0
    while len(results) < B:
        if seeds:
            src = np.zeros((S,), np.int64)
            admit = np.zeros((S,), np.bool_)
            for j, (s, r) in enumerate(seeds):
                src[s], admit[s], binding[s] = j, True, r
            lane = contexts[[r for _, r in seeds]]
            jcarry = fns["seed"](jp, jc, jcarry, jnp.asarray(lane), jnp.asarray(src.astype(np.int32)),
                                 jnp.asarray(admit))
            tcarry = bs.init_slots(tp, tc, tcarry, to_torch(lane), torch.from_numpy(src),
                                   torch.from_numpy(admit))
        mask = np.zeros((S,), np.bool_)
        mask[list(binding)] = True
        if k == 1:
            jcarry, jdone = fns["step"](jp, jc, jcarry, jnp.asarray(mask), EOS, valid_size=valid_size)
            tcarry, tdone = bs.decode_step(tp, tc, tcarry, torch.from_numpy(mask), EOS,
                                           valid_size=valid_size)
        else:
            jcarry, jdone, jsteps = fns["multi"](jp, jc, jcarry, jnp.asarray(mask), EOS, jnp.int32(k),
                                                 valid_size=valid_size)
            tcarry, tdone, tsteps = bs.decode_multi_step(tp, tc, tcarry, torch.from_numpy(mask), EOS,
                                                         k=k, valid_size=valid_size)
            assert int(tsteps) == int(jsteps), ticks
        done = tdone.numpy()
        np.testing.assert_array_equal(done, np.asarray(jdone))
        np.testing.assert_array_equal(tcarry.t.numpy(), np.asarray(jcarry.t))
        np.testing.assert_array_equal(tcarry.alive.numpy(), np.asarray(jcarry.alive))
        np.testing.assert_array_equal(tcarry.search.live_words.numpy(), np.asarray(jcarry.search.live_words))
        np.testing.assert_array_equal(tcarry.search.fin_words.numpy(), np.asarray(jcarry.search.fin_words))
        finished = []
        if done.any():
            want = fns["harvest"](jcarry)
            got = bs.harvest_slots(tcarry, return_alphas=True)
            retire = np.zeros((S,), np.bool_)
            for s in map(int, np.nonzero(done)[0]):
                np.testing.assert_array_equal(got.words[s].numpy(), np.asarray(want.words)[s])
                np.testing.assert_array_equal(got.lengths[s].numpy(), np.asarray(want.lengths)[s])
                np.testing.assert_allclose(got.log_scores[s].numpy(), np.asarray(want.log_scores)[s],
                                           rtol=0, atol=ATOL)
                np.testing.assert_allclose(got.alphas[s].numpy(), np.asarray(want.alphas)[s],
                                           rtol=0, atol=ATOL)
                assert int(got.steps_run[s]) == int(np.asarray(want.steps_run)[s])
                results[binding.pop(s)] = tuple(
                    x[s].clone() for x in (got.words, got.log_scores, got.lengths, got.alphas, got.steps_run)
                )
                retire[s] = True
                finished.append(s)
            jcarry = jbs.retire_slots(jcarry, jnp.asarray(retire))
            tcarry = bs.retire_slots(tcarry, torch.from_numpy(retire))
        ticks += 1
        assert ticks < 10 * B * tc.max_caption_length, "pool livelock"
        seeds = plan.send(finished)
    return [results[r] for r in range(B)]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("valid_size", [None, 25])
@pytest.mark.parametrize("burst", [False, True], ids=["staggered", "bursty"])
def test_stepped_decode_matches_jax(burst, valid_size, k):
    """5 requests through a 2x2 pool, admitted one per tick (staggered)
    or a page every third tick (bursty), with ``decode_step`` (k=1) or a
    4-deep ``decode_multi_step`` window."""
    jc, tc, jp, tp, contexts = _setup(B=5)
    got = _lockstep(jc, tc, jp, tp, contexts, burst=burst, admit_every=3 if burst else 1,
                    k=k, valid_size=valid_size)
    lengths = [int(r[2][0]) for r in got]
    assert min(lengths) < tc.max_caption_length  # some slot sealed early and retired


def test_stepped_decode_matches_the_pallas_masked_body(monkeypatch):
    """The JAX side through the Pallas masked body (interpret mode), the
    port through its masked plain version."""
    monkeypatch.setattr(pallas_attention, "FORCE_INTERPRET", True)
    masked_calls = []
    kernel = pallas_attention.fused_attend

    def spy(*args, row_mask=None, **kw):
        masked_calls.append(row_mask is not None)
        return kernel(*args, row_mask=row_mask, **kw)

    monkeypatch.setattr(pallas_attention, "fused_attend", spy)
    jc, tc, jp, tp, contexts = _setup(B=3, seed=1)
    assert jc.use_pallas_attention and jc.num_attend_layers == 2
    _lockstep(jc, tc, jp, tp, contexts, pages=1, width=2, k=4, fns=_jax_fns())
    assert masked_calls and all(masked_calls)  # traced through the masked body


# -- the port's own invariants, bitwise ---------------------------------------


def _seeded(tc, tp, contexts, slots, live):
    """A pool of ``slots`` with requests 0..live-1 seeded into slots
    0..live-1; returns (carry, slot_mask)."""
    carry = bs.init_slot_pool(tc, slots, return_alphas=True)
    admit = torch.zeros((slots,), dtype=torch.bool)
    admit[:live] = True
    src = torch.zeros((slots,), dtype=torch.int64)
    src[:live] = torch.arange(live)
    carry = bs.init_slots(tp, tc, carry, to_torch(contexts[:live]), src, admit)
    return carry, admit.clone()


def _assert_carry_equal(a, b, rows=None, slots=None):
    for name, x, y in (("ctx", a.ctx, b.ctx), ("ctx_proj", a.ctx_proj, b.ctx_proj)):
        torch.testing.assert_close(x[rows], y[rows], rtol=0, atol=0, msg=name)
    for x, y in zip(a.state, b.state):
        torch.testing.assert_close(x[rows], y[rows], rtol=0, atol=0)
    for x, y in zip(a.search, b.search):
        torch.testing.assert_close(x[slots], y[slots], rtol=0, atol=0)
    torch.testing.assert_close(a.t[slots], b.t[slots], rtol=0, atol=0)
    torch.testing.assert_close(a.alive[slots], b.alive[slots], rtol=0, atol=0)


def test_a_window_equals_single_steps():
    _, tc, _, tp, contexts = _setup(B=3)
    carry, mask = _seeded(tc, tp, contexts, slots=4, live=3)
    window, done_w, steps_w = bs.decode_multi_step(tp, tc, carry, mask, EOS, k=4)
    single, done_s = carry, torch.zeros(4, dtype=torch.bool)
    for _ in range(4):
        single, d = bs.decode_step(tp, tc, single, mask, EOS)
        done_s |= d
    _assert_carry_equal(window, single, rows=slice(None), slots=slice(None))
    torch.testing.assert_close(done_w, done_s, rtol=0, atol=0)
    assert int(steps_w) == 4


@pytest.mark.parametrize("valid_size", [None, 25])
def test_stepped_decode_equals_the_monolithic_search(valid_size):
    """Staggered admission through a 2x2 pool gives each image the words,
    scores, lengths and alphas of the port's monolithic beam search."""
    jc, tc, jp, tp, contexts = _setup(B=5)
    mono = bs.beam_search(tp, tc, to_torch(contexts), EOS, valid_size=valid_size,
                          return_alphas=True)
    got = _lockstep(jc, tc, jp, tp, contexts, valid_size=valid_size)
    for i, (words, scores, lengths, alphas, _) in enumerate(got):
        for g, w in ((words, mono.words[i]), (scores, mono.log_scores[i]),
                     (lengths, mono.lengths[i]), (alphas, mono.alphas[i])):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"image {i}")


@pytest.mark.parametrize("use_pallas_attention", [True, False])
def test_nan_in_dead_slots_never_reaches_live_ones(use_pallas_attention):
    """Two live slots beside two dead ones whose carry is NaN and Inf:
    the live slots step bitwise as in a clean pool."""
    _, tc, _, tp, contexts = _setup(B=2, use_pallas_attention=use_pallas_attention)
    clean, mask = _seeded(tc, tp, contexts, slots=4, live=2)
    K = tc.beam_size

    def poison(x, rows):
        x = x.clone()
        if x.is_floating_point():
            x[rows] = float("nan")
            x[rows.start] = float("inf")
        return x

    dead_rows, dead_slots = slice(2 * K, 4 * K), slice(2, 4)
    dirty = clean._replace(
        ctx=poison(clean.ctx, dead_rows),
        ctx_proj=poison(clean.ctx_proj, dead_rows),
        state=bs.DecoderState(*(poison(x, dead_rows) for x in clean.state)),
        search=bs.SearchState(*(poison(x, dead_slots) for x in clean.search)),
    )
    for _ in range(3):
        clean, done_c = bs.decode_step(tp, tc, clean, mask, EOS)
        dirty, done_d = bs.decode_step(tp, tc, dirty, mask, EOS)
        torch.testing.assert_close(done_c, done_d, rtol=0, atol=0)
    _assert_carry_equal(clean, dirty, rows=slice(0, 2 * K), slots=slice(0, 2))
    for x in dirty.state:
        assert torch.isfinite(x[: 2 * K]).all()


def test_window_stops_counting_when_the_pool_drains():
    """A slot that seals after n steps in a window of n + 4: steps_run is
    n, the remaining iterations change nothing, and a pool with nothing
    active runs 0 steps."""
    _, tc, _, tp, contexts = _setup(B=5)
    mono = bs.beam_search(tp, tc, to_torch(contexts), EOS, return_steps=True)
    image = next(i for i in range(5) if int(mono.lengths[i, 0]) < tc.max_caption_length)
    n = bs.beam_search(tp, tc, to_torch(contexts[image:image + 1]), EOS, return_steps=True).steps_run
    carry, mask = _seeded(tc, tp, contexts[image:image + 1], slots=2, live=1)
    carry, done, steps = bs.decode_multi_step(tp, tc, carry, mask, EOS, k=n + 4)
    assert int(steps) == n < n + 4
    assert done.tolist() == [True, False]
    stepped, _ = _seeded(tc, tp, contexts[image:image + 1], slots=2, live=1)
    for _ in range(n):
        stepped, _ = bs.decode_step(tp, tc, stepped, mask, EOS)
    _assert_carry_equal(carry, stepped, rows=slice(None), slots=slice(None))
    after, done2, steps2 = bs.decode_multi_step(tp, tc, carry, torch.zeros(2, dtype=torch.bool), EOS, k=4)
    assert int(steps2) == 0 and not done2.any()
    _assert_carry_equal(after, carry, rows=slice(None), slots=slice(None))


def test_choose_decode_depth():
    depths = (1, 2, 4, 8)
    assert choose_decode_depth(depths, 0, 0) == 8    # idle: the deepest
    assert choose_decode_depth(depths, 1, 0) == 1    # a request queued
    assert choose_decode_depth(depths, 7, 3) == 1
    assert choose_decode_depth(depths, 0, 2) == 1    # held for a free slot
    assert choose_decode_depth((1,), 0, 0) == 1
    assert choose_decode_depth((1, 4), 0, 0) == 4


# -- PagedSlotPool on a CPU engine ----------------------------------------------


@pytest.fixture(scope="module")
def engine():
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, ServingState

    jc, tc = configs(serve_slot_pages=2, serve_page_width=4, beam_size=2, max_caption_length=4)
    flat = flat_params(jax_variables(jc))
    vocab = Vocabulary(tc.vocabulary_size)
    vocab.build([f"w{i} w{i + 1} ." for i in range(60)])
    state = ServingState(params_from_flat(flat, tc, "cpu"), step=0)
    return ServeEngine(tc, state, vocab, device="cpu")


def _images(engine, n, seed=0):
    size = engine.config.image_size
    return list(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8))


def test_pool_admits_what_fits_and_harvest_frees(engine):
    from sat_tpu_torch.serve.slot_pool import PagedSlotPool

    pool = PagedSlotPool(engine)
    pool.warmup()
    assert (pool.slots, pool.lane_widths, pool.free_count()) == (8, [1, 2, 4], 8)
    items = [(im, f"req{i}") for i, im in enumerate(_images(engine, 11))]
    assert pool.admit(items) == 8
    assert (pool.occupancy(), pool.free_count()) == (8, 0)
    assert pool.inflight_payloads() == [f"req{i}" for i in range(8)]
    assert pool.admit(items[8:]) == 0
    harvested = []
    while pool.occupancy():
        done, steps = pool.multi_step(4)
        done = done.numpy()
        assert 1 <= int(steps) <= 4
        payloads, words, lengths, scores, steps_run, alphas = pool.harvest(done)
        assert alphas is None  # serve_quality off
        assert len(payloads) == len(words) == len(scores) == int(done.sum())
        assert (steps_run >= 1).all() and np.isfinite(scores).all()
        harvested += payloads
    assert sorted(harvested) == sorted(p for _, p in items[:8])
    assert pool.free_count() == 8
    assert pool.admit(items[8:]) == 3 and pool.occupancy() == 3
    pool.reset()
    assert pool.free_count() == 8 and pool.inflight_payloads() == []


def test_pool_encodes_at_the_smallest_lane_that_fits(engine, monkeypatch):
    from sat_tpu_torch.serve.slot_pool import PagedSlotPool

    pool = PagedSlotPool(engine)
    pool.reset()
    widths = []
    encode = engine.encode_images

    def spy(images, *slot):
        widths.append(len(images))
        return encode(images, *slot)

    monkeypatch.setattr(engine, "encode_images", spy)
    images = _images(engine, 8, seed=1)
    for n in (1, 3, 2):
        pool.admit([(im, i) for i, im in enumerate(images[:n])])
    assert widths == [1, 4, 2]
    assert pool.admit([(im, i) for i, im in enumerate(images[:5])]) == 2  # 6 of 8 slots taken
    assert widths[-1] == 2


def test_pool_rejects_a_depth_off_the_ladder(engine):
    from sat_tpu_torch.serve.slot_pool import PagedSlotPool

    pool = PagedSlotPool(engine)
    pool.reset()
    assert pool.decode_depths == (1, 2, 4, 8)
    with pytest.raises(KeyError, match="ladder"):
        pool.multi_step(3)
    done = pool.step()
    assert done.shape == (8,) and not done.any()
