"""Device resolution and numeric settings shared by the entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Asking for CUDA without one raises —
    the entry points never fall back to the CPU on their own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def fp32_strict() -> None:
    """The reference computes in full fp32: turn TF32 off for cuDNN
    convolutions and cuBLAS matmuls (cuDNN's default is TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
