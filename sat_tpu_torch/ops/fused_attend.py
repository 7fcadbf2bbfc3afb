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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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


def _launch(lib, t1, t2, w2, contexts, row_mask, out_ctx, out_alpha, mode: int) -> int:
    fn = lib.fused_attend_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    ``row_mask``); on a CPU tensor: the plain version.  Nothing falls
    back from the one to the other."""
    if compute_dtype not in _MODES:
        raise ValueError(f"fused_attend: compute_dtype {compute_dtype!r} not in {sorted(_MODES)}")
    if t1.device.type == "cpu":
        return fused_attend_reference(t1, t2, w2, contexts, row_mask, compute_dtype)
    if t1.device.type != "cuda":
        raise ValueError(f"fused_attend: no kernel for device {t1.device}")
    _check(t1, t2, w2, contexts)
    if row_mask is not None:
        _check_mask(row_mask, t1)
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
