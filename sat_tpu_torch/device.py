"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when no card is visible.  There is
no silent move to the CPU.

A process that cannot be handed ``device="cpu"`` — a replica the router
spawns, the supervisor's child — is asked through its environment:
``SAT_TORCH_DEVICE=cpu`` makes ``resolve_device(None)`` the CPU, and
``SAT_TORCH_DEVICE=cuda`` (or unset) the card.  Any other value raises.
It is a request, like ``device="cpu"``, never a fallback.

A CUDA device resolves to the indexed card (``cuda:0``).  Resolving it
turns TF32 off for cuDNN convolutions and cuBLAS matmuls, process-wide,
so float32 means float32 on the card (bf16 work ignores both switches).
The switches are set, not toggled around a call, so no thread can see
them flipped under it.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "SAT_TORCH_DEVICE"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
        if device not in ("cuda", "cpu"):
            raise ValueError(f"sat_tpu_torch: {DEVICE_ENV}={device!r}: expected 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sat_tpu_torch: no CUDA device is visible; pass device='cpu' "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sat_tpu_torch: unsupported device {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            # name the card itself ("cuda:0"), as a tensor on it does
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
