"""sat_tpu_torch — Show, Attend and Tell on PyTorch and CUDA.

The port of ``sat_tpu`` (the JAX package, which stays the reference) to an
NVIDIA H100.  It imports ``torch``, never ``jax``, and nothing of
``sat_tpu``.  Ported so far: batch-mode caption serving — VGG16 encoder,
soft-attention LSTM decoder, beam search, the HTTP server — with the
attention step as a hand-written CUDA kernel (``ops.fused_attend``).

Exports resolve lazily, so ``import sat_tpu_torch`` loads nothing heavy.
"""

from importlib import import_module

_EXPORTS = {
    "Config": ".config",
    "Vocabulary": ".data.vocabulary",
    "encode": ".models.captioner",
    "beam_search": ".ops.beam_search",
    "fused_attend": ".ops.fused_attend",
    "params_from_flat": ".train.checkpoint",
    "params_to_flat": ".train.checkpoint",
    "load_serving_state": ".serve.engine",
    "ServeEngine": ".serve.engine",
    "CaptionServer": ".serve.server",
    "serve": ".serve.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'sat_tpu_torch' has no attribute {name!r}")
    return getattr(import_module(_EXPORTS[name], __name__), name)
