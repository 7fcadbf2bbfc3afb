"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when no card is visible.  There is
no silent move to the CPU.

Resolving a CUDA device turns TF32 off for cuDNN convolutions and cuBLAS
matmuls, process-wide, so float32 means float32 on the card (bf16 work
ignores both switches).  The switches are set, not toggled around a call,
so no thread can see them flipped under it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sat_tpu_torch: no CUDA device is visible; pass device='cpu' "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sat_tpu_torch: unsupported device {dev}")
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
