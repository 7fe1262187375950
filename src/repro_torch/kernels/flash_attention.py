"""Flash attention on the card (replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``).

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``: bf16 on
the tensor cores (P rounded to bf16 for P V, as the reference's jnp
attention does), fp32 on CUDA cores.  Its plain version is
``kernels/ref.py::flash_attention_ref``, which computes in fp32; all
return q's dtype, as ``flash_attention_pallas`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128, 256)      # the instantiations in csrc/flash_attention.cu
_TYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), one type (fp32 or
    bf16), on CUDA and contiguous, Hq a multiple of Hkv and Dh one of
    ``HEAD_DIMS`` -> (B, Sq, Hq, Dh) in q's type."""
    if q.dtype not in _TYPES:
        raise ValueError(f"flash_attention: q must be fp32 or bf16, got "
                         f"{q.dtype}")
    build.require(q, "q", (None,) * 4, q.dtype)
    b, sq, hq, dh = q.shape
    build.require(k, "k", (b, None, None, dh), q.dtype)
    build.require(v, "v", tuple(k.shape), q.dtype)
    skv, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} is not built; "
                         f"the kernel takes {HEAD_DIMS}")
    if hkv == 0 or hq % hkv or skv == 0:
        raise ValueError(f"flash_attention: {hq} q heads over {hkv} kv "
                         f"heads, {skv} kv positions")
    if window < 0 or prefix_len < 0:
        raise ValueError("flash_attention: window and prefix_len must be "
                         ">= 0")
    if any(t.data_ptr() % 16 for t in (q, k, v)):      # float4 / cp.async
        raise ValueError("flash_attention: operands must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load("flash_attention")
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, dh, int(q.dtype == torch.bfloat16), int(causal),
        int(window), int(prefix_len), 1.0 / math.sqrt(dh),
        build.stream_ptr(q)), "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
