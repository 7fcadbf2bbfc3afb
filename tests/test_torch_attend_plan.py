"""The CUDA ``fused_attend``'s launch plan (``attend_plan``), on the CPU:
it depends on (N, da, D) alone, covers every position and column once,
cuts its ring so each chunk fits its stage, and fits in shared memory at
every shape the decode path and the card tests use."""

import inspect

import pytest
import torch

from sat_tpu_torch.ops import fused_attend as fa

torch.set_num_threads(2)

FLAGSHIP = (196, 512, 512)  # VGG16's 14x14 grid, da = D = 512
# (N, da, D) of every shape in tests/test_torch_cuda.py and chip_smoke.py
CARD_SHAPES = [
    FLAGSHIP, (7, 24, 40), (1, 4, 4), (13, 13, 7), (12000, 8, 300), (49, 512, 2048),
    (5, 22, 38),
]
SMEM_PER_SM = 233472  # 228 KB; the card reserves 1 KB of it for each block


@pytest.mark.parametrize("N,da,D", CARD_SHAPES)
def test_plan_covers_every_position_and_column_once(N, da, D):
    p = fa.attend_plan(N, da, D)
    cluster = p.cluster
    assert cluster == fa.CLUSTER == 8
    positions = [n for s in range(cluster) for n in p.positions(s, N)]
    columns = [d for s in range(cluster) for d in p.columns(s, D)]
    assert positions == list(range(N))
    assert columns == list(range(D))
    if D % 4 == 0:  # float4 copies and sums: every block's columns start 16-byte aligned
        assert p.cols_per_block % 4 == 0
    for s in range(cluster):
        t1_chunks, ctx_chunks = p.chunks(s, N, D)
        rows = len(p.positions(s, N))
        # the chunks of each stream cover it, and no chunk is empty: t1 rows
        # of the block's positions, contexts rows of its columns over all N
        assert (t1_chunks - 1) * p.t1_chunk_rows < rows <= t1_chunks * p.t1_chunk_rows or rows == 0
        if len(p.columns(s, D)):
            assert (ctx_chunks - 1) * p.ctx_chunk_rows < N <= ctx_chunks * p.ctx_chunk_rows
        else:
            assert ctx_chunks == 0
    assert p.stage_floats % 4 == 0
    assert p.t1_chunk_rows * da <= p.stage_floats
    # a contexts row takes its padded stride in the stage
    stride = fa._ctx_stride(p.cols_per_block, D % 4 == 0)
    assert stride >= p.cols_per_block and p.ctx_chunk_rows * stride <= p.stage_floats


@pytest.mark.parametrize("N,da,D", CARD_SHAPES)
def test_plan_fits_shared_memory(N, da, D):
    p = fa.attend_plan(N, da, D)
    assert 0 < p.smem_bytes <= fa.SMEM_LIMIT == 227 * 1024
    # the ring is the bulk of it: two stages, the rest is small
    assert p.smem_bytes >= 4 * fa.STAGES * p.stage_floats


def test_flagship_plan_keeps_each_block_in_shared_memory():
    """At the decode path's shape a block's t1 rows and contexts slice fit
    whole (one chunk each, all in flight from the start), and two blocks
    fit on an SM."""
    N, da, D = FLAGSHIP
    p = fa.attend_plan(N, da, D)
    assert p.cluster == fa.CLUSTER
    assert p.chunks(0, N, D) == (1, 1)
    assert p.t1_chunk_rows == p.rows_per_block and p.ctx_chunk_rows == N
    assert 2 * (p.smem_bytes + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("N,da,D", [(5, 22, 38), (1, 3, 5), (3, 7, 9), (7, 24, 40)])
def test_small_and_odd_shapes_give_a_valid_plan(N, da, D):
    """N smaller than the cluster: some blocks score no position (and D
    smaller than it: some sum no column); da and D need not be multiples
    of 4."""
    p = fa.attend_plan(N, da, D)
    idle = [s for s in range(p.cluster) if not p.positions(s, N)]
    assert len(idle) == p.cluster - N
    assert p.chunks(idle[0], N, D)[0] == 0
    assert sum(len(p.columns(s, D)) for s in range(p.cluster)) == D


def test_ring_takes_chunks_where_a_slice_does_not_fit():
    N, da, D = 12000, 8, 300
    p = fa.attend_plan(N, da, D)
    assert p.stage_floats == fa.STAGE_CAP
    assert p.chunks(0, N, D)[1] == -(-N // p.ctx_chunk_rows) > 1


def test_plan_refuses_shapes_over_shared_memory():
    for big in ((60000, 512, 512), (196, 60000, 512)):
        with pytest.raises(ValueError, match="shared"):
            fa.attend_plan(*big)
    # the N limit the docstring states: 15488 less da rounded up to 4
    fa.attend_plan(14976, 512, 512)
    fa.attend_plan(15480, 8, 300)
    for big in ((14977, 512, 512), (15481, 8, 300)):
        with pytest.raises(ValueError, match="shared"):
            fa.attend_plan(*big)
    for bad in ((0, 512, 512), (196, 0, 512), (196, 512, 0)):
        with pytest.raises(ValueError):
            fa.attend_plan(*bad)
    # phase 3 has one thread a column unit: at most 256 of them a block
    fa.attend_plan(196, 512, 8192)
    fa.attend_plan(196, 512, 2047)
    for D in (8200, 2049):
        with pytest.raises(ValueError, match="columns"):
            fa.attend_plan(196, 512, D)


def test_plan_takes_the_shapes_alone():
    params = list(inspect.signature(fa.attend_plan).parameters)
    assert params == ["N", "da", "D"]


class _FakeEntry:
    """Stands in for the ctypes function: records the arguments."""

    argtypes = None

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self):
        self.fused_attend_launch = _FakeEntry()
        self.fused_attend_error_string = _FakeEntry()


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("N,da,D", [FLAGSHIP, (5, 22, 38)])
def test_launch_passes_the_same_plan_for_any_batch_and_mask(N, da, D, monkeypatch):
    """The plan handed to the C entry is attend_plan(N, da, D) whatever the
    batch size and whether or not a mask is given."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    lib = _FakeLib()
    seen = set()
    for B in (1, 3, 48, 96, 108):
        t1, t2 = torch.zeros(B, N, da), torch.zeros(B, da)
        w2, ctx = torch.zeros(da, 1), torch.zeros(B, N, D)
        out_ctx, out_alpha = torch.empty(B, D), torch.empty(B, N)
        for mask in (None, torch.arange(B) % 2 == 0):
            fa._launch(lib, t1, t2, w2, ctx, mask, out_ctx, out_alpha, 1)
            args = lib.fused_attend_launch.calls[-1]
            assert args[7:12] == (B, N, da, D, 1)
            seen.add(args[13:])
    # every field but smem_bytes, which the C entry computes from the others
    assert seen == {tuple(fa.attend_plan(N, da, D))[:6]}
    assert fa.AttendPlan._fields[6:] == ("smem_bytes",)
    argtypes = lib.fused_attend_launch.argtypes
    assert len(argtypes) == len(args) == 13 + 6
