"""Fused soft-attention step — the port of ``sat_tpu.ops.pallas_attention``.

Per batch row: ``temp = t1 + t2``, ``logit = rnd(Σ_da rnd(temp)·rnd(w2))``,
``alpha = softmax_N(logit)``, ``ctx = Σ_N alpha·contexts``, with ``rnd``
the rounding through ``compute_dtype`` that the Pallas kernel applies.

:func:`fused_attend` launches the hand-written CUDA kernel
(``csrc/fused_attend.cu``) for tensors on the card, and runs
:func:`fused_attend_reference`, its plain torch version, for tensors on
the CPU.  Any other device raises.  With ``row_mask`` (the slot pool's
stepped decode) the card runs the kernel's masked body: dead rows come
out +0.0 whatever their inputs, live rows bitwise equal to the unmasked
body.  ``fused_attend.launches`` counts unmasked launches and
``fused_attend.masked_launches`` masked ones.

:func:`attend_plan` is the kernel's launch plan: the cluster of blocks
that takes each row, which positions and columns each block owns, and
how the shared-memory ring is cut.  It depends on (N, da, D) alone, so
a row's outputs do not depend on the batch it is in.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

_MODES = {"float32": 0, "bfloat16": 1}


def _rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def reference_logits(
    t1: torch.Tensor, t2: torch.Tensor, w2: torch.Tensor, compute_dtype: str = "float32"
) -> torch.Tensor:
    """[B, N] pre-softmax logits with the kernel's rounding: an fp32
    product of rounded operands, summed in fp32, the sum rounded."""
    dt = getattr(torch, compute_dtype)
    temp = t1.float() + t2.float().unsqueeze(1)
    w = _rnd(w2.float().reshape(1, 1, -1), dt)
    return _rnd((_rnd(temp, dt) * w).sum(dim=-1), dt)


def fused_attend_reference(
    t1: torch.Tensor,
    t2: torch.Tensor,
    w2: torch.Tensor,
    contexts: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fused_attend`: the logits of
    :func:`reference_logits`, softmax and context sum in fp32.
    ``row_mask`` [B] bool or uint8: zero rows get logits 0 before the
    softmax and alpha/ctx 0 after (the Pallas masked body)."""
    logits = reference_logits(t1, t2, w2, compute_dtype)
    valid = None if row_mask is None else row_mask.reshape(-1, 1) != 0
    if valid is not None:
        logits = torch.where(valid, logits, torch.zeros_like(logits))
    alpha = torch.softmax(logits, dim=-1)
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    ctx = torch.bmm(alpha.unsqueeze(1), contexts.float()).squeeze(1)
    if valid is not None:
        ctx = torch.where(valid, ctx, torch.zeros_like(ctx))
    return ctx, alpha


# Agreement of an unmasked (ctx, alpha) with the plain version's.  float32:
# only the summation order differs, so elementwise (rtol, atol).  bfloat16:
# both sides round at the same points and every difference before the
# softmax is rounded away, except where an fp32 sum lands on a bf16
# rounding boundary and the two orders round it one ulp apart (a "flip").
# So alpha is held in log space, row by row: log(alpha/alpha_plain) less
# its row median (the shared normaliser) must be within LOG_NOISE
# everywhere but at flips, a flip may move one logit by at most one bf16
# ulp, and flips may be at most 1 in 1000 of the logits (a kernel that
# rounds in another place, or not at all, moves nearly every one).  ctx is
# then held against alpha_kernel @ contexts in float64.
ELEMENTWISE_TOL = {"alpha": (1e-5, 1e-6), "ctx": (1e-5, 1e-5)}
LOG_NOISE = 1e-5
CTX_TOL = (1e-5, 1e-5)
MAX_FLIP_SHARE = 1e-3


def agreement(got, want, contexts, logits, compute_dtype: str) -> dict:
    """Hold ``got`` = (ctx, alpha) against the plain version's ``want`` on
    the same inputs; ``logits`` are :func:`reference_logits` of those
    inputs.  Returns a report with ``ok`` and, if not, ``why``."""
    (gc, ga), (wc, wa) = (x.double() for x in got), (x.double() for x in want)
    rep = dict(max_abs_err=max(float((gc - wc).abs().max()), float((ga - wa).abs().max())))
    if not (torch.isfinite(gc).all() and torch.isfinite(ga).all()):
        return dict(rep, ok=False, why="non-finite output")
    if compute_dtype == "float32":
        for name, g, w in (("ctx", gc, wc), ("alpha", ga, wa)):
            rtol, atol = ELEMENTWISE_TOL[name]
            if bool(((g - w).abs() > atol + rtol * w.abs()).any()):
                return dict(rep, ok=False, why=f"{name} over rtol {rtol} atol {atol}")
        return dict(rep, ok=True)
    if compute_dtype != "bfloat16":
        raise ValueError(f"agreement: compute_dtype {compute_dtype!r} not in {sorted(_MODES)}")
    live = wa > 1e-30
    if bool((ga[~live].abs() > 2e-30).any()):
        return dict(rep, ok=False, why="alpha non-zero where the plain version underflows")
    d = torch.where(live, torch.log(ga.clamp_min(1e-300)) - torch.log(wa.clamp_min(1e-300)),
                    torch.nan)
    d = (d - d.nanmedian(dim=-1, keepdim=True).values).nan_to_num(0.0).abs()
    mant, exp = torch.frexp(logits.double())
    ulp = torch.where(mant == 0, torch.zeros_like(mant), torch.ldexp(torch.ones_like(mant), exp - 8))
    flips = d > LOG_NOISE
    own = torch.bmm(ga.unsqueeze(1), contexts.double()).squeeze(1)
    rep.update(
        log_err=float(torch.where(flips, 0.0, d).max()),
        flips=int(flips.sum()),
        max_flips=max(1, int(MAX_FLIP_SHARE * d.numel())),
        ctx_err=float((gc - own).abs().max()),
    )
    if bool((d > ulp * 1.01 + LOG_NOISE).any()):
        return dict(rep, ok=False, why="a logit moved by more than one bf16 ulp")
    if rep["flips"] > rep["max_flips"]:
        return dict(rep, ok=False, why=f"{rep['flips']} logits rounded apart (at most {rep['max_flips']})")
    rtol, atol = CTX_TOL
    if bool(((gc - own).abs() > atol + rtol * own.abs()).any()):
        return dict(rep, ok=False, why=f"ctx off alpha @ contexts over rtol {rtol} atol {atol}")
    return dict(rep, ok=True)


# Constants of csrc/fused_attend.cu: threads a block (kThreads), ring
# stages (kStages), shared memory a block may take (kMaxSmem), blocks per
# row (kMaxCluster: 8, the portable cluster size).  The C entry takes the
# plan's first six fields and computes the shared-memory bytes itself, by
# its layout(); ``smem_bytes`` below is the same sum, so that a shape that
# does not fit raises here, before anything is launched.
THREADS = 256
STAGES = 2
SMEM_LIMIT = 232448
CLUSTER = 8
# Floats a ring stage may hold (53 KiB): at the flagship shape two stages
# and the rest of the layout stay under half an SM's shared memory, so two
# blocks fit on an SM.
STAGE_CAP = 13568


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ctx_stride(cw: int, vec_d: bool) -> int:
    """Floats between two contexts rows in shared memory (ctx_stride in
    the CUDA source): a block's cw columns padded to an odd number of
    16-byte (or 4-byte) units, so phase 3's reads of several rows fall in
    distinct banks."""
    return 4 * ((cw // 4) | 1) if vec_d else cw | 1


class AttendPlan(NamedTuple):
    """Launch plan of the CUDA kernel for one (N, da, D).

    A row is taken by a cluster of ``cluster`` blocks.  Block s scores the
    positions :meth:`positions` and sums the columns :meth:`columns` over
    all N; it streams its t1 rows in chunks of ``t1_chunk_rows`` and its
    contexts slice in chunks of ``ctx_chunk_rows`` rows through a ring of
    ``STAGES`` stages of ``stage_floats`` floats.  ``smem_bytes`` is its
    dynamic shared memory."""

    cluster: int
    rows_per_block: int
    cols_per_block: int
    t1_chunk_rows: int
    ctx_chunk_rows: int
    stage_floats: int
    smem_bytes: int

    def positions(self, s: int, N: int) -> range:
        n0 = min(N, s * self.rows_per_block)
        return range(n0, min(N, n0 + self.rows_per_block))

    def columns(self, s: int, D: int) -> range:
        c0 = min(D, s * self.cols_per_block)
        return range(c0, min(D, c0 + self.cols_per_block))

    def chunks(self, s: int, N: int, D: int) -> Tuple[int, int]:
        """(t1 chunks, contexts chunks) block s streams through its ring:
        the t1 rows of its positions, then all N rows of its columns."""
        t1 = _ceil_div(len(self.positions(s, N)), self.t1_chunk_rows)
        ctx = _ceil_div(N, self.ctx_chunk_rows) if len(self.columns(s, D)) else 0
        return t1, ctx


@functools.lru_cache(maxsize=64)
def attend_plan(N: int, da: int, D: int) -> AttendPlan:
    """The kernel's plan for rows of N positions, da attention units and
    D context channels.  It depends on the shapes alone, never on the
    batch size or the mask: that is what keeps a row's outputs the same
    in every batch.

    Raises ValueError for shapes the kernel cannot take.  Shared memory
    holds two ring stages of at most ``STAGE_CAP`` floats, t2 and w2, and
    the N logits and alphas, within 227 KB a block: so, for da up to
    ``STAGE_CAP``, N is at most 15488 less da rounded up to 4 (14976 at
    da = 512).  Phase 3 has one
    thread a column unit of its block: so D is at most 8192 when it is a
    multiple of 4 (float4 columns) and 2048 otherwise."""
    if min(N, da, D) <= 0:
        raise ValueError(f"attend_plan: N={N}, da={da}, D={D}")
    cluster = CLUSTER
    vec_d = D % 4 == 0  # the kernel moves and sums float4 columns when it can
    nb = _ceil_div(N, cluster)
    cw = _ceil_div(D // 4, cluster) * 4 if vec_d else _ceil_div(D, cluster)
    if cw // (4 if vec_d else 1) > THREADS:
        raise ValueError(f"attend_plan: D={D} gives {cw} columns a block, more than it sums")
    stride = _ctx_stride(cw, vec_d)
    stage = _round4(max(min(STAGE_CAP, max(nb * da, N * stride)), da, stride))
    plan = AttendPlan(
        cluster=cluster, rows_per_block=nb, cols_per_block=cw,
        t1_chunk_rows=min(nb, stage // da), ctx_chunk_rows=min(N, stage // stride),
        stage_floats=stage,
        smem_bytes=4 * (STAGES * stage + 2 * _round4(da) + 2 * _round4(N)),
    )
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"attend_plan: N={N}, da={da}, D={D} needs {plan.smem_bytes} bytes of shared "
            f"memory a block, over {SMEM_LIMIT}"
        )
    return plan


def _launch(lib, t1, t2, w2, contexts, row_mask, out_ctx, out_alpha, mode: int) -> int:
    fn = lib.fused_attend_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
        lib.fused_attend_error_string.argtypes = [ctypes.c_int]
        lib.fused_attend_error_string.restype = ctypes.c_char_p
    B, N, da = t1.shape
    D = contexts.shape[-1]
    return fn(
        t1.data_ptr(), t2.data_ptr(), w2.data_ptr(), contexts.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(),
        out_ctx.data_ptr(), out_alpha.data_ptr(), B, N, da, D, mode,
        torch.cuda.current_stream(t1.device).cuda_stream,
        *attend_plan(N, da, D)[:6],  # the C entry's Plan: every field but smem_bytes
    )


def _check_mask(row_mask, t1) -> None:
    if row_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"fused_attend: row_mask must be bool or uint8, got {row_mask.dtype}")
    if tuple(row_mask.shape) != (t1.shape[0],):
        raise ValueError(
            f"fused_attend: row_mask {tuple(row_mask.shape)} must be [B] = ({t1.shape[0]},)"
        )
    if row_mask.device != t1.device:
        raise ValueError(f"fused_attend: row_mask on {row_mask.device}, t1 on {t1.device}")
    if not row_mask.is_contiguous():
        raise ValueError("fused_attend: row_mask must be contiguous")


def _check(t1, t2, w2, contexts) -> None:
    for name, x in (("t1", t1), ("t2", t2), ("w2", w2), ("contexts", contexts)):
        if x.device != t1.device:
            raise ValueError(f"fused_attend: {name} on {x.device}, t1 on {t1.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"fused_attend: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"fused_attend: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"fused_attend: {name} must be 16-byte aligned")
    if t1.dim() != 3 or contexts.dim() != 3:
        raise ValueError("fused_attend: t1 [B,N,da] and contexts [B,N,D] must be 3-D")
    B, N, da = t1.shape
    if tuple(t2.shape) != (B, da) or w2.numel() != da or tuple(contexts.shape[:2]) != (B, N):
        raise ValueError(
            f"fused_attend: shapes t1 {tuple(t1.shape)}, t2 {tuple(t2.shape)}, "
            f"w2 {tuple(w2.shape)}, contexts {tuple(contexts.shape)} do not agree"
        )


def _refuse_grad(*inputs: torch.Tensor) -> None:
    """Raise when autograd would need the kernel's gradient: its outputs
    carry no ``grad_fn``, so the gradients would silently come out zero."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        raise RuntimeError(
            "fused_attend: the CUDA kernel has no backward (as the JAX package's Pallas "
            "call has none); differentiate through the plain attention (the decoder's "
            "training path), or call it under torch.no_grad()"
        )


def fused_attend(
    t1: torch.Tensor,
    t2: torch.Tensor,
    w2: torch.Tensor,
    contexts: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx [B, D], alpha [B, N]) float32 from t1 [B, N, da], t2 [B, da],
    w2 [da, 1] and contexts [B, N, D], all float32 and contiguous.

    ``row_mask``: None, or a contiguous [B] bool or uint8 tensor on t1's
    device whose zero rows are dead (outputs +0.0, inputs never read).

    On a CUDA tensor: one launch of the CUDA kernel on the current stream
    (counted in ``fused_attend.launches``, or ``masked_launches`` with a
    ``row_mask``); it raises when autograd would need its gradient (grad
    enabled and an input requiring grad), since the kernel has no
    backward.  On a CPU tensor: the plain version.  Nothing falls back
    from the one to the other."""
    if compute_dtype not in _MODES:
        raise ValueError(f"fused_attend: compute_dtype {compute_dtype!r} not in {sorted(_MODES)}")
    if t1.device.type == "cpu":
        return fused_attend_reference(t1, t2, w2, contexts, row_mask, compute_dtype)
    if t1.device.type != "cuda":
        raise ValueError(f"fused_attend: no kernel for device {t1.device}")
    _check(t1, t2, w2, contexts)
    if row_mask is not None:
        _check_mask(row_mask, t1)
    _refuse_grad(t1, t2, w2, contexts)
    from . import build

    lib = build.load("fused_attend")
    B, N, _ = t1.shape
    out_ctx = torch.empty((B, contexts.shape[-1]), device=t1.device, dtype=torch.float32)
    out_alpha = torch.empty((B, N), device=t1.device, dtype=torch.float32)
    err = _launch(lib, t1, t2, w2, contexts, row_mask, out_ctx, out_alpha, _MODES[compute_dtype])
    if err:
        raise RuntimeError(
            f"fused_attend launch failed: {lib.fused_attend_error_string(err).decode()}"
        )
    if row_mask is None:
        fused_attend.launches += 1
    else:
        fused_attend.masked_launches += 1
    return out_ctx, out_alpha


fused_attend.launches = 0
fused_attend.masked_launches = 0
