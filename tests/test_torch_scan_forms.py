"""CPU emulation of the recurrent kernels' arithmetic, without a card.

``csrc/wkv6.cu`` runs the RWKV-6 recurrence as a segmented recurrence
over time chunks of ``kernels/wkv6.py::CHUNK`` steps: phase A runs the
step recurrence inside each chunk (chunk 0 from s0, the rest from 0,
the bonus term summed once a step), phase B carries the state across
chunks with each chunk's decay product, phase C adds (r_t * P_t) . S_in
to every later chunk's y.  ``csrc/selective_scan.cu`` spreads a
channel's N states over 8 lanes, takes exp(dt a) as exp2(dt a') with a'
= a log2(e) rounded once, and sums y over the lanes in a fixed tree.
The helpers here repeat those orders with PyTorch on the CPU (fused
multiply-adds through fp64, which is exact for the product), so the
tolerance the card checks use, 1e-5 of the largest magnitude, is shown
to hold for the arithmetic itself, against the JAX reference's kernels
in interpret mode and its chunked WKV form.  The MUFU's own error is
not emulated: exp2 here is PyTorch's; the card tests and
``chip_smoke.py`` measure the kernel against the plain version.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan_pallas
from repro.kernels.wkv6 import wkv6_pallas
from repro.models.rwkv6 import wkv6_chunked
from repro_torch.kernels import ref
from repro_torch.kernels.wkv6 import CHUNK
from torch_threads import torch_intra_op_threads  # noqa: F401

LOG2E = 1.4426950408889634
LANES = 8                        # SS_LANES in csrc/selective_scan.cu


def _err(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64."""
    return (a.double() * b.double() + c.double()).float()


# --- wkv6: phases A, B, C ---------------------------------------------------


def wkv6_segmented(r, k, v, w, u, s0, chunk=CHUNK):
    """``csrc/wkv6.cu``'s arithmetic: (y, sT) in fp32 from fp32 operands
    r, k, v, w (B, T, H, N), u (H, N), s0 (B, H, N, N)."""
    b, t, h, n = r.shape
    y = torch.zeros(b, t, h, n)
    chunks = max(1, -(-t // chunk))
    s_loc, decay = [], []
    for ck in range(chunks):                                  # phase A
        s = s0.clone() if ck == 0 else torch.zeros(b, h, n, n)
        dprod = torch.ones(b, h, n)
        for tt in range(ck * chunk, min(t, (ck + 1) * chunk)):
            rt, kt, vt, wt = r[:, tt], k[:, tt], v[:, tt], w[:, tt]
            bonus = (rt * u * kt).sum(-1, keepdim=True)      # (B, H, 1)
            acc = torch.einsum("bhi,bhij->bhj", rt, s)
            y[:, tt] = _fma(vt, bonus, acc)
            s = _fma(wt[..., None], s, kt[..., None] * vt[..., None, :])
            dprod = dprod * wt
        s_loc.append(s)
        decay.append(dprod)
    if chunks == 1:
        return y, s_loc[0]
    s_in = [None, s_loc[0]]                                   # phase B
    for ck in range(1, chunks):
        s_in.append(_fma(decay[ck][..., None], s_in[-1], s_loc[ck]))
    for ck in range(1, chunks):                               # phase C
        p = torch.ones(b, h, n)
        for tt in range(ck * chunk, min(t, (ck + 1) * chunk)):
            y[:, tt] += torch.einsum("bhi,bhij->bhj", r[:, tt] * p,
                                     s_in[ck])
            p = p * w[:, tt]
    return y, s_in[-1]


def _wkv_inputs(b, t, h, seed, edge=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, 64)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, 0, (b, t, h, 64)))).astype(np.float32)
    if edge:          # exact zeros, under 1e-30, the largest fp32 below 1
        flat = w.reshape(-1)
        flat[::7], flat[3::11], flat[5::13] = 0.0, 1e-31, 1 - 2 ** -24
    u = (0.5 * rng.normal(size=(h, 64))).astype(np.float32)
    s0 = rng.normal(size=(b, h, 64, 64)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,t,h,edge", [
    (1, 40, 2, False),              # T < C: phase A alone, from s0
    (1, CHUNK + 1, 2, False),       # one step past a chunk
    (1, CHUNK + 1, 2, True),
    (2, 2 * CHUNK + 22, 1, False),  # T no multiple of C, three chunks
    (2, 2 * CHUNK + 22, 1, True),
])
def test_wkv6_segmented_matches_pallas_and_chunked(b, t, h, edge):
    """The A/B/C segmentation with the kernel's C against
    ``wkv6_pallas(interpret=True)``, and with model-like decays against
    the reference's ``wkv6_chunked`` (log-space decays, pairwise
    scores): y and sT within 1e-5 of the largest magnitude, from a
    nonzero s0.  The edge cases add decays of exactly 0, 1e-31 and 1 -
    2^-24; there ``wkv6_chunked`` itself reads 3e-5 to 1e-4 off the
    Pallas kernel (it clamps w at 1e-30, so each zero adds -69 to the
    cumulative log, and differences of those sums lose fp32 digits),
    which is why the kernel multiplies decays instead."""
    ops_np = _wkv_inputs(b, t, h, seed=t + b, edge=edge)
    y, s_t = wkv6_segmented(*(torch.tensor(z) for z in ops_np))
    assert torch.isfinite(y).all() and torch.isfinite(s_t).all()
    wants = [wkv6_pallas(*map(jnp.asarray, ops_np), interpret=True)]
    if not edge:
        wants.append(wkv6_chunked(*map(jnp.asarray, ops_np)))
    for want_y, want_s in wants:
        assert _err(y, want_y) <= 1e-5
        assert _err(s_t, want_s) <= 1e-5


def test_wkv6_segmented_empty_sequence_returns_s0():
    """T = 0: no step runs, y is empty and sT is s0 (as the plain
    version gives)."""
    r, k, v, w, u, s0 = (torch.tensor(z) for z in _wkv_inputs(2, 0, 3, 0))
    y, s_t = wkv6_segmented(r, k, v, w, u, s0)
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    assert y.shape == want_y.shape == (2, 0, 3, 64)
    assert torch.equal(s_t, s0) and torch.equal(want_s, s0)


def test_wkv6_decay_products_stay_exact_at_zero():
    """A decay of exactly 0 zeroes the carried state in the segmented
    form, as in the step recurrence: with every decay of the last chunk
    0 at its first step, sT is that chunk's own state."""
    r, k, v, w, u, s0 = (torch.tensor(z)
                         for z in _wkv_inputs(1, 2 * CHUNK, 1, 5))
    w[:, CHUNK] = 0.0
    y, s_t = wkv6_segmented(r, k, v, w, u, s0)
    y_tail, s_tail = wkv6_segmented(r[:, CHUNK:], k[:, CHUNK:],
                                    v[:, CHUNK:], w[:, CHUNK:], u,
                                    torch.zeros_like(s0))
    assert torch.equal(s_t, s_tail)
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    assert _err(y, want_y) <= 1e-5 and _err(s_t, want_s) <= 1e-5


# --- selective_scan: lanes, exp2, the reduction tree ------------------------


def scan_lanes(x, dt, bmat, cmat, a, h0):
    """``csrc/selective_scan.cu``'s arithmetic: (y, hT) in fp32.  N pads
    to 8, 16 or 32; lane q holds states [q S, q S + S), S = NS / 8.  A
    step's y: each lane's states summed in order (FMA), then the 8
    partial sums by the reduce-scatter over distances 4, 2, 1, which for
    the lane q = t mod 8 that keeps step t adds
    ((P_q + P_q^4) + (P_q^2 + P_q^6)) + ((P_q^1 + P_q^5) + (P_q^3 + P_q^7))."""
    b, t, di = x.shape
    n = bmat.shape[-1]
    ns = 8 if n <= 8 else 16 if n <= 16 else 32
    s_per = ns // LANES
    pad = lambda z: torch.nn.functional.pad(z.float(), (0, ns - n))
    a2 = pad(a) * torch.tensor(LOG2E, dtype=torch.float32)    # (Di, NS)
    h = pad(h0)
    bm, cm = pad(bmat), pad(cmat)
    dtf = dt.float()
    dtx = dtf * x.float()
    y = torch.zeros(b, t, di)
    for tt in range(t):
        e = torch.exp2(dtf[:, tt, :, None] * a2)
        e = torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)  # ftz
        h = _fma(e, h, dtx[:, tt, :, None] * bm[:, tt, None, :])
        part = torch.zeros(b, di, LANES)
        for q in range(LANES):
            for s in range(s_per):
                nn = q * s_per + s
                part[..., q] = _fma(h[..., nn], cm[:, tt, None, nn],
                                    part[..., q])
        q = tt % LANES
        pr = lambda m: part[..., q ^ m]
        y[:, tt] = (((pr(0) + pr(4)) + (pr(2) + pr(6)))
                    + ((pr(1) + pr(5)) + (pr(3) + pr(7))))
    return y, h[..., :n]


def _scan_inputs(b, t, di, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, di)) - 4)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, t, n)).astype(np.float32)
              for _ in range(2))
    a = -np.exp(0.5 * rng.normal(size=(di, n))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(b, di, n))).astype(np.float32)
    return x, dt, bm, cm, a, h0


@pytest.mark.parametrize("b,t,di,n", [(2, 37, 40, 7), (1, 70, 24, 16),
                                      (1, 45, 16, 32)])
def test_scan_lanes_match_pallas(b, t, di, n):
    """The lane split with exp2 of the pre-scaled a and the fixed
    shuffle tree against ``selective_scan_pallas(interpret=True)``: y and
    hT within 1e-5 of the largest magnitude, N = 7 (padded), 16 and
    32."""
    ops_np = _scan_inputs(b, t, di, n, seed=t + n)
    y, h_t = scan_lanes(*(torch.tensor(z) for z in ops_np))
    want_y, want_h = selective_scan_pallas(*map(jnp.asarray, ops_np),
                                           interpret=True)
    assert _err(y, want_y) <= 1e-5 and _err(h_t, want_h) <= 1e-5


@pytest.mark.parametrize("log_a_lo,log_a_hi,dt_scale", [
    (-1.0, 1.0, 1.0),     # memory up to ~100 steps
    (-3.0, 0.0, 1.0),     # ~700 steps
    (-1.0, 1.0, 0.1),     # ~900 steps
])
def test_prescaled_rate_against_exact_exp_over_long_memories(
        log_a_lo, log_a_hi, dt_scale):
    """exp2(dt a') with a' = a log2(e) rounded once, against exp(dt a)
    taken in fp64 and rounded once (the fp32 decay closest to exact),
    over 2048 steps of model-like random dt: the final states within
    1e-6 of scale (4e-8 to 1.3e-7 on the CPU), so the pre-scaled rate
    costs the 1e-5 tolerance little.  The card's MUFU.EX2 adds its own
    error, which only the card tests see."""
    rng = np.random.default_rng(7)
    di, n, t = 64, 16, 2048
    a = torch.tensor(-np.exp(rng.uniform(log_a_lo, log_a_hi, (di, n))),
                     dtype=torch.float32)
    dt = torch.tensor(dt_scale * np.log1p(np.exp(
        rng.normal(size=(t, di, 1)) - 4)), dtype=torch.float32)
    inp = torch.tensor(rng.normal(size=(t, di, n)), dtype=torch.float32)
    a2 = a * torch.tensor(LOG2E, dtype=torch.float32)
    h_ex2 = torch.zeros(di, n)
    h_exact = torch.zeros(di, n)
    for tt in range(t):
        h_ex2 = _fma(torch.exp2(dt[tt] * a2), h_ex2, dt[tt] * inp[tt])
        h_exact = _fma(torch.exp((dt[tt] * a).double()).float(), h_exact,
                       dt[tt] * inp[tt])
    assert _err(h_ex2, h_exact) <= 1e-6
    assert math.isfinite(float(h_ex2.abs().max()))
