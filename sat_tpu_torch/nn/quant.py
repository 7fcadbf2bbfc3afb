"""Post-training quantization of the frozen CNN encoder for serving — the
port of ``sat_tpu.nn.quant``.

``config.encoder_quant`` picks the serve-time precision of the VGG16 or
ResNet50 conv stack:

* ``off``  — this module never runs;
* ``bf16`` — conv kernels stored in bfloat16, the float32 bias added in
  bfloat16;
* ``int8`` — conv kernels per-output-channel *symmetric* int8 with
  float32 scales (absmax/127 a channel), activations quantized per
  tensor against ranges from a one-time calibration pass, every conv an
  int8 × int8 → int32 product with the dequant fused into the bias add.
  The contexts stay float32.

ResNet50's frozen batch norms are folded into the conv before them
(``w' = w·s``, ``b' = (b − mean)·s + beta``, ``s = gamma/sqrt(var + ε)``),
so the quantized graph is conv + bias (+ relu) for both CNNs, walked by
``vgg16.quant_forward`` / ``resnet50.quant_forward``.

The int8 conv is im2col (the SAME-padded patches of the int8 activations,
gathered by slicing) and ``torch._int_mm`` over them: cuBLAS's int8
product on the card, an exact integer product on the CPU, so the int32
accumulators are the same on both.  ``_int_mm`` wants the reduction and
output widths to be multiples of 8 and more than 16 rows: the patches
and the kernel are padded with zeros (conv1's 7·7·3 = 147 to 152) and
small products with zero rows, which add nothing.

The serve engine quantizes once at load, before warmup, and then holds
only the quantized encoder (``qcnn``).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import resnet50, vgg16
from .layers import BN_EPSILON, pad_same, same_padding

_EPS = 1e-6  # absmax floor: an all-zero tensor quantizes to scale = eps/127


# ---------------------------------------------------------------------------
# weight side
# ---------------------------------------------------------------------------


def quantize_kernel(kernel: torch.Tensor):
    """[cout, cin, kh, kw] float32 → (int8 kernel, float32 per-output-channel
    scales): ``q = round(w / scale)`` clipped to ±127, ``scale =
    max(absmax, ε)/127`` over each output channel."""
    k = kernel.float()
    absmax = k.abs().amax(dim=(1, 2, 3)).clamp_min(_EPS)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(k / scale.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return q, scale


def fold_bn(kernel, bias, gamma, beta, mean, var, eps: float = BN_EPSILON):
    """Fold a frozen batch norm into the OIHW conv before it:
    ``gamma·(conv(x) + bias − mean)/sqrt(var + eps) + beta``."""
    s = gamma.float() / torch.sqrt(var.float() + eps)
    k = kernel.float() * s.view(-1, 1, 1, 1)
    b = torch.zeros_like(s) if bias is None else bias.float()
    return k, (b - mean.float()) * s + beta.float()


def _convs(tree: Dict[str, Any], out: Dict[str, Dict[str, Any]]) -> None:
    """{conv layer name: its node} at any depth (names are unique across a
    CNN)."""
    for name, sub in tree.items():
        if isinstance(sub, dict):
            if "weight" in sub:
                out[name] = sub
            else:
                _convs(sub, out)


def _bns(tree: Dict[str, Any], out: Dict[str, Dict[str, Any]]) -> None:
    """{batch-norm name: its leaves}, parameters and statistics merged."""
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if {"scale", "bias"} <= set(sub) or {"mean", "var"} <= set(sub):
            out.setdefault(name, {}).update(sub)
        else:
            _bns(sub, out)


def _bn_name_for(conv_name: str) -> str:
    """The reference's scope names: conv1 → bn_conv1, res2a_branch1 →
    bn2a_branch1."""
    return "bn_conv1" if conv_name == "conv1" else "bn" + conv_name[len("res"):]


def folded_convs(params: Dict[str, Any], config, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat {conv name: {'kernel' OIHW float32, 'bias' float32}} with
    ResNet50's frozen batch norms folded in; ``params`` holds ``cnn`` and,
    for ResNet50, ``batch_stats``.  With ``device``, each conv and its
    batch norm move there one at a time and fold there, so a tree on the
    host puts only the folded kernels on the device."""

    def on(t):
        return t if t is None or device is None else t.to(device)

    convs: Dict[str, Dict[str, Any]] = {}
    _convs(params["cnn"], convs)
    bns: Dict[str, Dict[str, Any]] = {}
    _bns(params["cnn"], bns)
    _bns(params.get("batch_stats", {}), bns)
    out = {}
    for name, leaves in convs.items():
        kernel, bias = on(leaves["weight"]).float(), on(leaves.get("bias"))
        bn = bns.get(_bn_name_for(name)) if config.cnn == "resnet50" else None
        if bn is not None:
            kernel, bias = fold_bn(kernel, bias, *(on(bn[k]) for k in ("scale", "bias", "mean", "var")))
        elif bias is None:
            bias = torch.zeros(kernel.shape[0], device=kernel.device)
        out[name] = {"kernel": kernel, "bias": bias.float()}
    return out


# ---------------------------------------------------------------------------
# conv functions of each precision (NCHW in, NCHW out)
# ---------------------------------------------------------------------------


def _walker(config):
    return vgg16.quant_forward if config.cnn == "vgg16" else resnet50.quant_forward


def _conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    x, padding = pad_same(x, kernel.shape[-2:], stride, 0.0)
    return F.conv2d(x, kernel, None, stride, padding)


def _fp32_conv_fn(folded, observer: Optional[Dict[str, float]] = None) -> Callable:
    """Float32 conv + bias (+ relu) over the folded graph; with
    ``observer``, records each conv's input absmax (the calibration)."""

    def conv(name, x, stride=1, relu=False):
        if observer is not None:
            observer[name] = max(observer.get(name, 0.0), float(x.abs().max()))
        y = _conv2d(x.float(), folded[name]["kernel"], stride) + folded[name]["bias"].view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    return conv


def _bf16_conv_fn(qcnn) -> Callable:
    def conv(name, x, stride=1, relu=False):
        spec = qcnn[name]
        y = _conv2d(x.to(torch.bfloat16), spec["kernel"], stride)
        y = y + spec["bias"].to(torch.bfloat16).view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    return conv


def _pad_to(x: torch.Tensor, dim: int, multiple: int, least: int = 0) -> torch.Tensor:
    """``x`` padded with zeros along ``dim`` to a multiple of ``multiple``
    and at least ``least``."""
    n = x.shape[dim]
    want = max(-(-n // multiple) * multiple, least)
    if want == n:
        return x
    shape = list(x.shape)
    shape[dim] = want - n
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The int32 accumulators of a SAME conv of int8 activations ``xq``
    [B, C, H, W] with an int8 OIHW kernel ``wq``: im2col by slicing, then
    ``torch._int_mm`` (K and N padded to multiples of 8, M to more than
    16).  Returns [B, O, Ho, Wo] int32."""
    O, C, kh, kw = wq.shape
    (hl, hh), (wl, wh) = same_padding(xq.shape[-2:], (kh, kw), (stride, stride))
    xp = F.pad(xq, (wl, wh, hl, hh))
    B, _, H, W = xp.shape
    Ho, Wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    xh = xp.permute(0, 2, 3, 1)   # NHWC: patches in (i, j, c) order, as the HWIO kernel
    cols = torch.cat(
        [xh[:, i:i + stride * (Ho - 1) + 1:stride, j:j + stride * (Wo - 1) + 1:stride, :]
         for i in range(kh) for j in range(kw)],
        dim=-1,
    ).reshape(B * Ho * Wo, kh * kw * C)
    # the kernel as [O, K] rows, handed over transposed (column-major
    # [K, O]): cuBLASLt's int8 product takes A row-major, B column-major
    w = wq.permute(0, 2, 3, 1).reshape(O, kh * kw * C)
    a = _pad_to(_pad_to(cols, 1, 8), 0, 1, least=17)
    acc = torch._int_mm(a, _pad_to(_pad_to(w, 1, 8), 0, 8).t())
    return acc[: B * Ho * Wo, :O].reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def _int8_conv_fn(qcnn) -> Callable:
    def conv(name, x, stride=1, relu=False):
        spec = qcnn[name]
        s_act = spec["act_scale"]
        xq = torch.clamp(torch.round(x.float() / s_act), -127, 127).to(torch.int8)
        acc = int8_conv(xq, spec["kernel"], stride)
        # the fused dequant: one float32 multiply-add an output element
        y = acc.float() * (s_act * spec["w_scale"]).view(1, -1, 1, 1) + spec["bias"].view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    return conv


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def calibration_batches(config, batches: Optional[Iterable] = None) -> List[np.ndarray]:
    """Mean-subtracted float32 image batches for the activation ranges: the
    first rows of the shard cache when one is there and on, else
    ``default_rng(0)`` uint8 noise, so both packages calibrate on the
    same bytes."""
    if batches is not None:
        return [np.asarray(b, np.float32) for b in batches]
    from ..data.images import ILSVRC_2012_MEAN

    n = config.encoder_quant_calib_batches
    b = config.encoder_quant_calib_batch_size
    s = config.image_size
    rows: Optional[np.ndarray] = None
    try:
        shard_files = sorted(glob.glob(os.path.join(config.shard_cache_dir, "*.npy")))
        if shard_files and config.shard_cache != "off":
            arr = np.load(shard_files[0], mmap_mode="r")
            if arr.ndim == 4 and arr.shape[1:] == (s, s, 3):
                rows = np.asarray(arr[: n * b], np.uint8)
    except Exception:
        rows = None  # an unreadable or mismatched cache: the noise below
    if rows is None or len(rows) == 0:
        rng = np.random.default_rng(0)
        rows = rng.integers(0, 256, size=(n * b, s, s, 3)).astype(np.uint8)
    imgs = rows.astype(np.float32) - ILSVRC_2012_MEAN
    return [imgs[i * b: (i + 1) * b] for i in range(max(1, len(imgs) // b))]


@torch.inference_mode()
def calibrate(folded, config, batches: Iterable[np.ndarray]) -> Dict[str, float]:
    """Each conv's input absmax over the float32 folded graph, run on the
    folded kernels' device over the calibration batches."""
    observer: Dict[str, float] = {}
    device = next(iter(folded.values()))["kernel"].device
    conv = _fp32_conv_fn(folded, observer)
    walker = _walker(config)
    for batch in batches:
        walker(conv, torch.from_numpy(np.asarray(batch, np.float32)).to(device))
    return observer


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@torch.inference_mode()
def quantize_encoder(params: Dict[str, Any], config, batches: Optional[Iterable] = None, device=None):
    """The ``qcnn`` tree for ``config.encoder_quant``, folded, calibrated
    and quantized on ``device`` (default: the params'): flat {conv name:
    spec}, with spec ``{'kernel' bf16, 'bias' f32}`` (bf16) or
    ``{'kernel' int8, 'w_scale' f32 [cout], 'bias' f32 [cout],
    'act_scale' float}`` (int8)."""
    mode = config.encoder_quant
    if mode == "off":
        raise ValueError("quantize_encoder called with encoder_quant='off'")
    folded = folded_convs(params, config, device)
    if mode == "bf16":
        return {
            name: {
                "kernel": spec["kernel"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
                "bias": spec["bias"],
            }
            for name, spec in folded.items()
        }
    ranges = calibrate(folded, config, calibration_batches(config, batches))
    qcnn = {}
    for name, spec in folded.items():
        q, w_scale = quantize_kernel(spec["kernel"])
        qcnn[name] = {
            "kernel": q,
            "w_scale": w_scale,
            "bias": spec["bias"],
            # float32, as the JAX package holds it
            "act_scale": float(np.float32(max(ranges.get(name, 0.0), _EPS) / 127.0)),
        }
    return qcnn


def quantized_encode(params: Dict[str, Any], config, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] float32 (mean-subtracted) → contexts [B, N, D]
    float32 through the quantized convs in ``params["qcnn"]``."""
    qcnn = params["qcnn"]
    if config.encoder_quant == "bf16":
        conv = _bf16_conv_fn(qcnn)
    elif config.encoder_quant == "int8":
        conv = _int8_conv_fn(qcnn)
    else:
        raise ValueError(f"encoder_quant={config.encoder_quant!r}")
    return _walker(config)(conv, images)
