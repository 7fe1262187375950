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


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU), so a host
    clock read after it times the work, not its enqueue."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev`` without waiting for the card: a host tensor
    bound for CUDA is staged through pinned memory and copied with
    ``non_blocking=True``, so the host goes on enqueuing (a pageable
    copy waits for the stream to drain).  PyTorch's pinned allocator
    keeps the staging buffer until the copy has run.  A no-op when ``t``
    is already there."""
    if t.device == dev or dev.type != "cuda" or t.device.type != "cpu":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
