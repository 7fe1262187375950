"""The Mamba-1 selective scan on the card (replaces
``repro/kernels/selective_scan.py::selective_scan_pallas``) and its
backward, which replaces no Pallas kernel (the reference trains through
the autodiff of its jnp scan).

``selective_scan_cuda`` launches ``csrc/selective_scan.cu``; its plain
version is ``kernels/ref.py::selective_scan_ref``.  Both return ``y``
and the final state in fp32, as ``selective_scan_pallas`` does;
``ops.selective_scan`` casts ``y`` to ``x``'s dtype, as the reference's
model scan does.  ``selective_scan_fwd_cuda`` also saves the state every
``SAVE`` steps.

``selective_scan_bwd_cuda`` (``csrc/selective_scan_bwd.cu``) is the VJP,
chunk-parallel over those ``SAVE``-step chunks; its plain version is
``kernels/ref.py::selective_scan_bwd_ref``.  Its bound is the fp32 rate
(~18 operations per (b, t, d, n): 0.036 ms at jamba's training
microbatch, B = 1, T = 1024, Di = 8192, N = 16).  The first design walked
every chunk of a 16-channel block in turn, staging 65 states in 95 KB of
shared memory, and summed dB and dC from 512 partials a row (0.80 ms).
This one walks every chunk at once: phase A forward from the saved
states (the states at phase C's sub-chunk starts, dC's terms, each
chunk's decay product and own gradient), phase B carries the state's
gradient over chunks elementwise, phase C sweeps each chunk back from
its true gradient, 4 states a lane, 64 channels a block, so dB and dC
leave as 128 partials a row at that shape (0.31-0.32 ms on an H100).
``bwd_scratch_parts`` gives its scratch from the shapes alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 32          # the largest N csrc/selective_scan.cu is built for
SAVE = 64               # SS_SAVE / SB_C: steps between the saved states
CHANNELS = 64           # SB_CHANNELS in csrc/selective_scan_bwd.cu: the
                        # channels of a block, one dB / dC partial each
_TYPES = (torch.float32, torch.bfloat16)


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor,
                        bmat: torch.Tensor, cmat: torch.Tensor,
                        a: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, T, Di) and bmat, cmat (B, T, N), all fp32 or all bf16,
    a (Di, N) fp32, h0 (B, Di, N) fp32, all on CUDA and contiguous, N <=
    ``MAX_STATE`` -> ``(y (B, T, Di) fp32, hT (B, Di, N) fp32)``."""
    return _launch(x, dt, bmat, cmat, a, h0, False)[:2]


def selective_scan_fwd_cuda(x: torch.Tensor, dt: torch.Tensor,
                            bmat: torch.Tensor, cmat: torch.Tensor,
                            a: torch.Tensor, h0: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """``selective_scan_cuda`` that also saves the states after every
    ``SAVE`` steps inside the sequence -> ``(y, hT, states (B, ceil(T /
    SAVE) - 1, Di, N) fp32)``, for ``selective_scan_bwd_cuda``."""
    return _launch(x, dt, bmat, cmat, a, h0, True)


def _launch(x, dt, bmat, cmat, a, h0, keep_states: bool):
    if x.dim() != 3 or x.dtype not in _TYPES:
        raise ValueError(f"selective_scan: x must be (B, T, Di) fp32 or "
                         f"bf16, got {tuple(x.shape)} {x.dtype}")
    b, t, di = x.shape
    n = bmat.shape[-1] if bmat.dim() == 3 else -1
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"selective_scan: state dim N = {n} is not built; "
                         f"the kernel takes 1 <= N <= {MAX_STATE}")
    build.require(x, "x", (b, t, di), x.dtype)
    build.require(dt, "dt", (b, t, di), x.dtype)
    build.require(bmat, "bmat", (b, t, n), x.dtype)
    build.require(cmat, "cmat", (b, t, n), x.dtype)
    build.require(a, "a", (di, n), torch.float32)
    build.require(h0, "h0", (b, di, n), torch.float32)
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    saves = max(-(-t // SAVE) - 1, 0)
    hs = (torch.empty((b, saves, di, n), dtype=torch.float32,
                      device=x.device) if keep_states else None)
    if b == 0 or di == 0:
        return y, h0.clone(), hs
    h_t = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    lib = build.load("selective_scan")
    build.check(lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), h0.data_ptr(), b, t, di, n,
        int(x.dtype == torch.bfloat16), y.data_ptr(), h_t.data_ptr(),
        hs.data_ptr() if keep_states and saves else None,
        build.stream_ptr(x)), "selective_scan")
    build.LAUNCHES["selective_scan"] += 1
    return y, h_t, hs


def padded_state(n: int) -> int:
    """The N the kernels are built for: 8, 16 or 32."""
    return 8 if n <= 8 else 16 if n <= 16 else 32


def bwd_scratch_parts(b: int, t: int, di: int, n: int) -> Dict[str, int]:
    """``selective_scan_bwd_cuda``'s scratch, fp32 elements by part in the
    order ``csrc/selective_scan_bwd.cu`` lays them out: phase A's states
    at the start of each of phase C's sub-chunks inside a chunk (16 steps,
    8 at N <= 8: C keeps a sub-chunk's states in registers), each chunk's
    Gloc (G after phase B) and decay product P but the first's, the
    per-64-channel dB and dC partials, and da's per-(b, chunk)
    partials."""
    chunks = max(1, -(-t // SAVE))
    subs = SAVE // (8 if padded_state(n) == 8 else 16)
    groups = -(-di // CHANNELS)
    return {"checkpoints": b * chunks * (subs - 1) * di * n,
            "g_carry": b * (chunks - 1) * di * n,
            "decay": b * (chunks - 1) * di * n,
            "db_partials": b * groups * t * n,
            "dc_partials": b * groups * t * n,
            "da_partials": b * chunks * di * n}


def selective_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor,
                            bmat: torch.Tensor, cmat: torch.Tensor,
                            a: torch.Tensor, h0: torch.Tensor,
                            states: torch.Tensor, dy: torch.Tensor,
                            dhT: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``selective_scan_cuda``'s ``(y, hT)`` under
    ``dy`` (B, T, Di) fp32 and ``dhT`` (B, Di, N) fp32 or None (zeros),
    from the forward's operands and its ``states``
    (``selective_scan_fwd_cuda``'s) -> ``(dx, ddt, dB,
    dC, da (Di, N), dh0)``: dx, ddt, dB and dC in x's dtype, da and dh0
    fp32."""
    if x.dim() != 3 or x.dtype not in _TYPES:
        raise ValueError(f"selective_scan_bwd: x must be (B, T, Di) fp32 "
                         f"or bf16, got {tuple(x.shape)} {x.dtype}")
    b, t, di = x.shape
    n = bmat.shape[-1] if bmat.dim() == 3 else -1
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"selective_scan_bwd: state dim N = {n} is not "
                         f"built; the kernel takes 1 <= N <= {MAX_STATE}")
    build.require(x, "x", (b, t, di), x.dtype)
    build.require(dt, "dt", (b, t, di), x.dtype)
    build.require(bmat, "bmat", (b, t, n), x.dtype)
    build.require(cmat, "cmat", (b, t, n), x.dtype)
    build.require(a, "a", (di, n), torch.float32)
    build.require(h0, "h0", (b, di, n), torch.float32)
    build.require(states, "states", (b, max(-(-t // SAVE) - 1, 0), di, n),
                  torch.float32)
    build.require(dy, "dy", (b, t, di), torch.float32)
    if dhT is not None:
        build.require(dhT, "dhT", (b, di, n), torch.float32)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dbm, dcm = torch.empty_like(bmat), torch.empty_like(cmat)
    if b == 0 or di == 0 or t == 0:
        return (dx.zero_(), ddt.zero_(), dbm.zero_(), dcm.zero_(),
                torch.zeros_like(a),
                dhT.clone() if dhT is not None else torch.zeros_like(h0))
    da, dh0 = torch.empty_like(a), torch.empty_like(h0)   # written whole
    scratch = torch.empty(sum(bwd_scratch_parts(b, t, di, n).values()),
                          dtype=torch.float32, device=x.device)
    lib = build.load("selective_scan_bwd")
    build.check(lib.selective_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), h0.data_ptr(),
        states.data_ptr() if states.numel() else None, dy.data_ptr(),
        dhT.data_ptr() if dhT is not None else None, b, t, di, n,
        int(x.dtype == torch.bfloat16), dx.data_ptr(), ddt.data_ptr(),
        dbm.data_ptr(), dcm.data_ptr(), da.data_ptr(), dh0.data_ptr(),
        scratch.data_ptr(), build.stream_ptr(x)), "selective_scan_bwd")
    build.LAUNCHES["selective_scan_bwd"] += 1
    return dx, ddt, dbm, dcm, da, dh0
