"""The plain reference of the caption model, in float32 with TF32 off.

Plain PyTorch operations on the benchmark's flat weights (``shapes``):
VGG16 (arXiv:1409.1556) or ResNet50 (arXiv:1512.03385) to the context
grid, then the soft-attention LSTM decoder of Show, Attend and Tell
(arXiv:1502.03044) as the reference implementation lays it out: a 2-layer
initializer MLP on the mean context, a 2-layer attention MLP, a TF1
LSTMCell (one ``[in + H, 4H]`` kernel, gates i, j, f, o, forget bias 1),
and a 2-layer decode MLP over ``[h, context, word embedding]``.  On top of
it: a beam search, the teacher-forced score of given words, and the
training loss.

It imports nothing of the program.  ``rnd`` (identity by default) is
applied to every operand of a conv and a matmul; the benchmark's controls
pass a rounding to a lower precision there.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .shapes import VGG_LAYERS, resnet_blocks

ILSVRC_2012_MEAN = (104.00698793, 116.66876762, 122.67891434)  # BGR order of the reference's mean file
BN_EPSILON = 1e-3
NEG = -1e30          # an empty or dead beam's score
FINISHED_BONUS = 1e6  # ranks every finished caption above every live one at the end

Flat = Dict[str, torch.Tensor]


def _same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` by the SAME rule: output ``ceil(in / stride)``, the
    low side getting the smaller half."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv(x, kernel_hwio, bias, stride, rnd):
    w = rnd(kernel_hwio.permute(3, 2, 0, 1))
    y = F.conv2d(_same(rnd(x), kernel_hwio.shape[0], stride), w, None, stride)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def _images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW less the ILSVRC mean."""
    mean = torch.tensor(ILSVRC_2012_MEAN, device=images.device)
    return (images.float() - mean).permute(0, 3, 1, 2)


def vgg16(flat: Flat, images: torch.Tensor, rnd: Callable = lambda t: t) -> torch.Tensor:
    """uint8 images [B, S, S, 3] -> contexts [B, (S/16)^2, 512]: 13 3x3
    convs with relu, a 2x2/2 max pool after each of the first four blocks."""
    x = _images(images)
    for name, _, pool in VGG_LAYERS:
        p = f"params/cnn/{name}/conv/"
        x = torch.relu(_conv(x, flat[p + "kernel"], flat[p + "bias"], 1, rnd))
        if pool:
            x = F.max_pool2d(_same(x, 2, 2, float("-inf")), 2, 2)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def resnet50(flat: Flat, images: torch.Tensor, rnd: Callable = lambda t: t) -> torch.Tensor:
    """uint8 images [B, S, S, 3] -> contexts [B, (S/32)^2, 2048]: batch
    norms on their running statistics."""

    def conv_bn(at, conv, bn, x, stride=1, relu=False):
        c = f"params/cnn/{at}{conv}/conv/"
        y = _conv(x, flat[c + "kernel"], flat.get(c + "bias"), stride, rnd)
        scale, shift = flat[f"params/cnn/{at}{bn}/scale"], flat[f"params/cnn/{at}{bn}/bias"]
        mean, var = flat[f"batch_stats/{at}{bn}/mean"], flat[f"batch_stats/{at}{bn}/var"]
        y = (y - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + BN_EPSILON)
        y = y * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    x = conv_bn("", "conv1", "bn_conv1", _images(images), 2, relu=True)
    x = F.max_pool2d(_same(x, 3, 2, float("-inf")), 3, 2)
    for block, tag, _, stride, projection in resnet_blocks():
        at = f"{block}/"
        short = conv_bn(at, f"res{tag}_branch1", f"bn{tag}_branch1", x, stride) if projection else x
        y = conv_bn(at, f"res{tag}_branch2a", f"bn{tag}_branch2a", x, stride, relu=True)
        y = conv_bn(at, f"res{tag}_branch2b", f"bn{tag}_branch2b", y, relu=True)
        y = conv_bn(at, f"res{tag}_branch2c", f"bn{tag}_branch2c", y)
        x = torch.relu(short + y)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def encode(cfg: Dict, flat: Flat, images: torch.Tensor, rnd: Callable = lambda t: t) -> torch.Tensor:
    return (vgg16 if cfg["cnn"] == "vgg16" else resnet50)(flat, images, rnd)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class State(NamedTuple):
    c: torch.Tensor  # LSTM cell
    h: torch.Tensor  # LSTM output


class Decoder:
    """The decoder's weights (``w``, by name under ``params/decoder/``)
    with one step's arithmetic."""

    def __init__(self, cfg: Dict, flat: Flat, rnd: Callable = lambda t: t):
        self.cfg, self.rnd = cfg, rnd
        self.w = {k[len("params/decoder/"):]: v for k, v in flat.items() if k.startswith("params/decoder/")}

    def dense(self, name, x, bias=True):
        y = self.rnd(x) @ self.rnd(self.w[name + "/kernel"])
        return y + self.w[name + "/bias"] if bias else y

    def init(self, contexts: torch.Tensor, drop=None) -> State:
        """The LSTM state from the mean context; ``drop(x, rate)``, when
        given, drops out the mean and the two hidden layers."""
        d = drop or (lambda x, r: x)
        rate = self.cfg.get("fc_drop_rate", 0.0)
        mean = d(contexts.mean(dim=1), rate)
        ta = torch.tanh(self.dense("initialize/fc_a1", mean))
        tb = torch.tanh(self.dense("initialize/fc_b1", mean))
        return State(self.dense("initialize/fc_a2", d(ta, rate)), self.dense("initialize/fc_b2", d(tb, rate)))

    def t1(self, contexts: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense("attend/fc_1a", contexts))

    def attend(self, contexts, t1, h):
        t2 = torch.tanh(self.dense("attend/fc_1b", h))
        logits = self.dense("attend/fc_2", t1 + t2.unsqueeze(1), bias=False)[..., 0]
        alpha = torch.softmax(logits, dim=-1)
        return torch.bmm(alpha.unsqueeze(1), contexts).squeeze(1), alpha

    def lstm(self, x, state: State) -> State:
        z = self.rnd(torch.cat([x, state.h], dim=-1)) @ self.rnd(self.w["lstm/kernel"]) + self.w["lstm/bias"]
        i, j, f, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * state.c + torch.sigmoid(i) * torch.tanh(j)
        return State(c, torch.sigmoid(o) * torch.tanh(c))

    def step(self, contexts, t1, state: State, word):
        """(new state, logits [B, V], alpha [B, N]) of one inference step."""
        context, alpha = self.attend(contexts, t1, state.h)
        emb = self.w["word_embedding/weights"][word]
        new = self.lstm(torch.cat([context, emb], dim=-1), state)
        hidden = torch.tanh(self.dense("decode/fc_1", torch.cat([new.h, context, emb], dim=-1)))
        return new, self.dense("decode/fc_2", hidden), alpha


def top(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the lower
    index first among equal values (the search's tie rule: equal scores,
    as the finished bonus makes of close ones, keep their order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def tile(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.repeat_interleave(k, dim=0)


@torch.no_grad()
def step_logps(dec: Decoder, contexts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """log p(every word) at each step of each row, the decoder fed the
    row's previous word (index 0 first).  contexts [M, N, D], words
    [M, T] -> [M, T, V]."""
    state, t1 = dec.init(contexts), dec.t1(contexts)
    last = torch.zeros(words.shape[0], dtype=torch.long, device=words.device)
    out = []
    for t in range(words.shape[1]):
        state, logits, _ = dec.step(contexts, t1, state, last)
        out.append(torch.log_softmax(logits, dim=-1))
        last = words[:, t]
    return torch.stack(out, 1)


def score_words(logp: torch.Tensor, words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of log p(word) of the first ``lengths`` words of each row, from
    ``step_logps``: logp [M, T, V], words [M, T], lengths [M] -> [M]."""
    picked = logp.gather(-1, words.unsqueeze(-1))[..., 0]
    t = torch.arange(words.shape[1], device=words.device)
    return torch.where(t < lengths.unsqueeze(1), picked, torch.zeros_like(picked)).sum(1)


@torch.no_grad()
def beam_search(dec: Decoder, contexts: torch.Tensor, K: int, T: int, eos: int):
    """Beam search without length normalization: (words [B, K, T],
    scores [B, K], lengths [B, K]), finished captions first.

    Each step takes the K best continuations over beam x vocabulary with
    the end token left out; a beam's end token becomes a finished caption
    only when it is among that beam's K + 1 most likely words, and the K
    best finished captions are kept.  Partial beams fill the result where
    fewer than K finished."""
    B = contexts.shape[0]
    dev = contexts.device
    ctx = tile(contexts, K)
    t1 = dec.t1(ctx)
    state = dec.init(ctx)
    rows = torch.arange(B, device=dev).unsqueeze(1)
    live = torch.full((B, K), NEG, device=dev)
    live[:, 0] = 0.0
    live_words = torch.zeros((B, K, T), dtype=torch.long, device=dev)
    live_len = torch.zeros((B, K), dtype=torch.long, device=dev)
    last = torch.zeros(B * K, dtype=torch.long, device=dev)
    fin = torch.full((B, K), NEG, device=dev)
    fin_words = torch.zeros_like(live_words)
    fin_len = torch.zeros_like(live_len)
    for t in range(T):
        state, logits, _ = dec.step(ctx, t1, state, last)
        V = logits.shape[-1]
        step = torch.log_softmax(logits, dim=-1).view(B, K, V)
        total = step + live.unsqueeze(-1)
        # finished candidates: each beam ended here, if the end token ranks in its top K + 1
        kth = top(step, K + 1)[0][..., -1]
        ended = torch.where(step[..., eos] >= kth, total[..., eos], torch.full_like(kth, NEG))
        ended_words = live_words.clone()
        ended_words[:, :, t] = eos
        cand = torch.cat([fin, ended], 1)
        fin, pick = top(cand, K)
        fin_words = torch.cat([fin_words, ended_words], 1)[rows, pick]
        fin_len = torch.cat([fin_len, live_len + 1], 1)[rows, pick]
        # continuations
        total[..., eos] = NEG
        live, flat = top(total.reshape(B, K * V), K)
        parent, word = flat // V, flat % V
        src = (rows * K + parent).reshape(-1)
        state = State(state.c[src], state.h[src])
        live_words = live_words[rows, parent].clone()
        live_words[:, :, t] = word
        live_len = live_len[rows, parent] + 1
        last = word.reshape(-1)
    key = torch.cat([torch.where(fin > NEG / 2, fin + FINISHED_BONUS, torch.full_like(fin, NEG)), live], 1)
    pick = top(key, K)[1]
    return (torch.cat([fin_words, live_words], 1)[rows, pick],
            torch.cat([fin, live], 1)[rows, pick],
            torch.cat([fin_len, live_len], 1)[rows, pick])


def no_tf32() -> None:
    """float32 means float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a tensor (its absmax
    at 448, the format's largest value), returned in float32.  The
    gradient passes the rounding unchanged (the products' own backward
    uses the rounded operands), so no gradient underflows the format."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - t).detach()



# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def dropper(generator: Optional[torch.Generator]) -> Callable:
    """Inverted dropout whose keep masks are ``rand < keep`` drawn from
    ``generator`` in call order; the identity without one."""

    def drop(x: torch.Tensor, rate: float) -> torch.Tensor:
        if generator is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    return drop


def train_loss(dec: Decoder, contexts: torch.Tensor, words: torch.Tensor, masks: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The training objective of one batch: masked cross-entropy over the
    mask sum, plus ``attention_loss_factor`` x 0.5 x the mean square of
    (1 - each position's attention summed over the caption), plus 0.5 x
    ``fc_kernel_regularizer_scale`` x the squares of the decoder's kernels
    and word embedding (the LSTM's excepted).  The decoder is fed <start>
    (0), then the caption's words; dropout draws its masks, in the order
    the graph meets its inputs, from ``generator``."""
    cfg, drop = dec.cfg, dropper(generator)
    fc, ls = cfg.get("fc_drop_rate", 0.0), cfg.get("lstm_drop_rate", 0.0)
    B, T = words.shape
    state = dec.init(contexts, drop)
    state = (state.c, state.h, state.h)  # cell, attention's h, the LSTM's own h
    inputs = torch.cat([torch.zeros_like(words[:, :1]), words[:, :-1]], dim=1)
    logits, alphas = [], []
    for t in range(T):
        c, out_h, rec_h = state
        t1 = torch.tanh(dec.dense("attend/fc_1a", drop(contexts, fc)))
        t2 = torch.tanh(dec.dense("attend/fc_1b", drop(out_h, fc)))
        a_logits = dec.dense("attend/fc_2", drop(t1 + t2.unsqueeze(1), fc), bias=False)[..., 0]
        alpha = torch.softmax(a_logits, dim=-1)
        context = torch.bmm(alpha.unsqueeze(1), contexts).squeeze(1)
        emb = dec.w["word_embedding/weights"][inputs[:, t]]
        new = dec.lstm(drop(torch.cat([context, emb], dim=-1), ls), State(c, rec_h))
        emitted, recurrent = drop(new.h, ls), drop(new.h, ls)
        hidden = torch.tanh(dec.dense("decode/fc_1", drop(torch.cat([emitted, context, emb], dim=-1), fc)))
        logits.append(dec.dense("decode/fc_2", drop(hidden, fc)))
        alphas.append(alpha)
        state = (new.c, emitted, recurrent)
    logits, alphas = torch.stack(logits, 1), torch.stack(alphas, 1)
    masks = masks.float()
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, words.unsqueeze(-1))[..., 0]
    cross_entropy = (ce * masks).sum() / masks.sum()
    attention = (alphas * masks.unsqueeze(-1)).sum(dim=1)
    attention_loss = cfg["attention_loss_factor"] * 0.5 * ((1.0 - attention) ** 2).sum() / attention.numel()
    reg = sum((w * w).sum() for name, w in dec.w.items()
              if w.dim() == 2 and not name.startswith("lstm/") and name.rsplit("/", 1)[1] in ("kernel", "weights"))
    return cross_entropy + attention_loss + 0.5 * cfg["fc_kernel_regularizer_scale"] * reg


class Adam:
    """Adam with the global-norm clip before it: gradients whose joint norm
    reaches ``clip`` are scaled to it; bias-corrected moments, ``eps``
    outside the root."""

    def __init__(self, leaves, lr, beta1, beta2, eps, clip):
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, beta1, beta2, eps, clip
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves, grads):
        """Updates ``leaves`` in place; returns the gradients as clipped."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if self.clip and float(norm) >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.add_(-self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return grads
