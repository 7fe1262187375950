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

``csrc/wkv6_bwd.cu`` is the recurrence's backward in the same chunks:
each chunk's local sweeps from zero (four threads a state row: the
forward walk for dr, then sub-chunks of ``kernels/wkv6.py::SUB`` steps
whose states enter dw only through row dots and the step recurrences of
G's dots; four a column of G for dv), the reverse carry of G over chunks
with the forward's decay products, and the carry terms through X, Q and
Y.  ``wkv6_bwd_segmented`` repeats that order and is held against
``jax.vjp`` of the reference's scans and against the port's plain
backward.

``csrc/selective_scan_bwd.cu`` is the selective scan's backward over the
forward's 64-step chunks: phase A walks each chunk forward (the states at
phase C's sub-chunk starts, dC's terms, the chunk's decay product P and
its own gradient Gloc summed forward), phase B carries the state's
gradient over chunks (G = P G + Gloc), phase C sweeps each chunk back
from its true G, and the sums over a channel's states (4 a lane, then a
tree over its lanes) and over channels (a tree over 4 channels of a warp,
16 partials a 64-channel group in order, then four runs of groups added
in a tree) run in fixed orders; a chunk's decay P is one exp2 of its
summed exponent, a' sum_t dt_t.  ``selective_scan_bwd_segmented`` repeats
that arithmetic and is held against ``jax.vjp`` of the reference's model
scan and against the port's plain backward.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.kernels.wkv6 import wkv6_pallas
from repro.models.mamba import _ssm_scan
from repro.models.rwkv6 import wkv6_chunked
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as scan_kernel
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch.kernels.wkv6 import CHUNK, SUB
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


# --- wkv6's backward: phases A (rows, columns), B, C -------------------------


def wkv6_bwd_segmented(r, k, v, w, u, s0, dy, dsT=None):
    """``csrc/wkv6_bwd.cu``'s arithmetic: (dr, dk, dv, dw, du, ds0) in
    fp32 from fp32 operands, the forward's operands and cotangents."""
    b, t, h, n = r.shape
    chunks = max(1, -(-t // CHUNK))
    bhn = lambda *s: torch.zeros(b, h, *s)
    dot = lambda m, x: torch.einsum("bhij,bhj->bhi", m, x)
    s_in, decay, s = [], [], s0         # the forward's scratch
    for ck in range(chunks):
        s_in.append(s)
        d = torch.ones(b, h, n)
        for tt in range(ck * CHUNK, min(t, (ck + 1) * CHUNK)):
            s = _fma(w[:, tt, ..., None], s, k[:, tt, ..., None]
                     * v[:, tt, :, None, :])
            d = d * w[:, tt]
        decay.append(d)
    dr, dk, dv, dw = (torch.zeros(b, t, h, n) for _ in range(4))
    du_part, g_start = [], []
    for ck in range(chunks):            # phase A, each chunk from zero
        t0, span = ck * CHUNK, min(CHUNK, t - ck * CHUNK)
        last = ck == chunks - 1
        g_end = dsT if last and dsT is not None else bhn(n, n)
        st, sub_s = s_in[ck], []        # rows: the forward walk, dr
        for c in range(span):
            if c % SUB == 0:
                sub_s.append(st)
            tt = t0 + c
            vdy = (v[:, tt] * dy[:, tt]).sum(-1, keepdim=True)
            dr[:, tt] = _fma(u * k[:, tt], vdy, dot(st, dy[:, tt]))
            st = _fma(w[:, tt, ..., None], st,
                      k[:, tt, ..., None] * v[:, tt, :, None, :])
        g, du = g_end, bhn(n)           # rows: sub-chunks from the last
        for q in reversed(range(len(sub_s))):
            steps = [t0 + c for c in range(q * SUB, min(span, q * SUB + SUB))]
            sig = [dot(sub_s[q], dy[:, tt]) for tt in steps]
            kap = [dot(g, v[:, tt]) for tt in steps]
            e = (g * sub_s[q]).sum(-1)
            for c in reversed(range(len(steps))):
                tt = steps[c]
                vdy = (v[:, tt] * dy[:, tt]).sum(-1, keepdim=True)
                dk[:, tt] = _fma(r[:, tt] * u, vdy, kap[c])
                hw = e                  # G_t . S_{t-1}, a Horner sum
                for s_ in range(c):
                    hw = _fma(w[:, steps[s_]], hw, k[:, steps[s_]] * kap[s_])
                dw[:, tt] = hw
                du = _fma(r[:, tt] * k[:, tt], vdy, du)
                for s_ in range(c):
                    a = (v[:, steps[s_]] * dy[:, tt]).sum(-1, keepdim=True)
                    kap[s_] = _fma(w[:, tt], kap[s_], r[:, tt] * a)
                e = _fma(w[:, tt], e, r[:, tt] * sig[c])
            acc, pr = bhn(n, n), torch.ones(b, h, n)
            for tt in steps:            # G over the whole sub-chunk
                acc = _fma((pr * r[:, tt])[..., None], dy[:, tt, :, None, :]
                           .expand(b, h, n, n), acc)
                pr = pr * w[:, tt]
            g = _fma(pr[..., None], g, acc)
        g_start.append(g)
        du_part.append(du)
        g = g_end                       # columns: dv
        for tt in reversed(range(t0, t0 + span)):
            bonus = (r[:, tt] * u * k[:, tt]).sum(-1, keepdim=True)
            dv[:, tt] = _fma(bonus, dy[:, tt],
                             torch.einsum("bhij,bhi->bhj", g, k[:, tt]))
            g = _fma(w[:, tt, ..., None], g,
                     r[:, tt, ..., None] * dy[:, tt, :, None, :])
    g_out = [None] * chunks             # phase B: G_out[ck], in reverse
    carry = g_start[-1]
    for ck in range(chunks - 2, -1, -1):
        g_out[ck] = carry
        carry = _fma(decay[ck][..., None], carry, g_start[ck])
    ds0 = carry
    for ck in range(chunks - 1):        # phase C: the carry terms
        g, t0 = g_out[ck], ck * CHUNK
        q, qs = torch.ones(b, h, n), [None] * CHUNK
        for c in reversed(range(CHUNK)):
            qs[c], q = q, q * w[:, t0 + c]
        y = (g * s_in[ck]).sum(-1)
        for c in range(CHUNK):
            tt = t0 + c
            x = dot(g, v[:, tt])
            dv[:, tt] += torch.einsum("bhij,bhi->bhj", g, qs[c] * k[:, tt])
            dk[:, tt] = _fma(qs[c], x, dk[:, tt])
            dw[:, tt] = _fma(qs[c], y, dw[:, tt])
            y = _fma(w[:, tt], y, k[:, tt] * x)
    return dr, dk, dv, dw, sum(du_part).sum(0), ds0


def _wkv_vjp(fn, ops_np, dy, ds):
    (_, s_t), vjp = jax.vjp(fn, *map(jnp.asarray, ops_np))
    return vjp((jnp.asarray(dy),
                jnp.zeros_like(s_t) if ds is None else jnp.asarray(ds)))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("b,t", [(1, CHUNK), (1, CHUNK + 1),
                                 (2, 2 * CHUNK + 1), (1, 3 * CHUNK + 8)])
def test_wkv6_bwd_segmented_matches_vjp_and_plain(b, t, with_ds, edge):
    """The backward's phases (local sweeps from zero in SUB-step
    sub-chunks, the reverse carry with D[k], the carry terms through X,
    Q and Y) at one chunk, one step past it, two chunks and a step, and
    a ragged fourth chunk, against the port's plain backward
    (``ref.wkv6_bwd_ref``, an explicit reverse sweep) and ``jax.vjp`` of
    the reference's per-step oracle, each gradient within 1e-5 of its
    largest magnitude (fp32 sums in other orders), and against
    ``jax.vjp`` of its default chunked form within 1e-4 (its decays go
    through log and exp, as ``tests/test_torch_train_families.py``
    holds the plain backward).  The edge cases add decays of exactly 0,
    1e-31 and 1 - 2^-24, where the chunked form clamps w at 1e-30 and
    loses digits (the forward's test above), so they are held against
    the two step recurrences only."""
    ops_np = _wkv_inputs(b, t, 2, seed=t + b, edge=edge)
    rng = np.random.default_rng(t)
    dy = rng.normal(size=(b, t, 2, 64)).astype(np.float32)
    ds = (rng.normal(size=(b, 2, 64, 64)).astype(np.float32)
          if with_ds else None)
    got = wkv6_bwd_segmented(*(torch.tensor(z) for z in ops_np),
                             torch.tensor(dy),
                             None if ds is None else torch.tensor(ds))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    wants = [(ref.wkv6_bwd_ref(*(torch.tensor(z) for z in ops_np),
                               torch.tensor(dy),
                               None if ds is None else torch.tensor(ds)),
              1e-5),
             (_wkv_vjp(ref_kref.wkv6_ref, ops_np, dy, ds), 1e-5)]
    if not edge:
        wants.append((_wkv_vjp(wkv6_chunked, ops_np, dy, ds), 1e-4))
    for want, tol in wants:
        for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                               want):
            assert _err(g, w_) <= tol, name


@pytest.mark.parametrize("b,t,h", [(1, 1024, 40), (1, 64, 3), (3, 200, 4)])
def test_wkv6_bwd_scratch_is_the_wrappers(monkeypatch, b, t, h):
    """``bwd_scratch_parts`` is what ``wkv6_bwd_cuda`` allocates and
    hands the launch (the wrapper run on CPU tensors with the build's
    checks and library stubbed): each chunk's sub-chunk states but the
    first, du's per-chunk partials and, past one chunk, Gloc_start and
    the three fp32 partials."""
    parts = wkv6_kernel.bwd_scratch_parts(b, t, h)
    chunks = -(-t // CHUNK)
    assert parts["sub_states"] == b * h * chunks * (CHUNK // SUB - 1) * 4096
    assert parts["du_partials"] == b * h * chunks * 64
    assert parts["g_start"] == (b * h * chunks * 4096 if chunks > 1 else 0)
    assert parts["local_dk_dv_dw"] == (3 * b * t * h * 64 if chunks > 1
                                       else 0)
    seen = {}

    class Lib:
        @staticmethod
        def wkv6_bwd_launch(*args):
            seen["scratch"] = args[-2]
            return 0
    monkeypatch.setattr(wkv6_kernel.build, "require", lambda *a: None)
    monkeypatch.setattr(wkv6_kernel.build, "load", lambda name: Lib)
    monkeypatch.setattr(wkv6_kernel.build, "stream_ptr", lambda x: 0)
    sizes = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        sizes[out.data_ptr()] = out.numel()
        return out
    monkeypatch.setattr(torch, "empty", empty)
    x = torch.zeros(b, t, h, 64)
    states = torch.zeros(b * h * (chunks if chunks > 1 else 0) * (4096 + 64))
    wkv6_kernel.wkv6_bwd_cuda(x, x, x, x, torch.zeros(h, 64),
                              torch.zeros(b, h, 64, 64), states, x)
    assert sizes[seen["scratch"]] == sum(parts.values())


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


# --- selective_scan's backward: phases A, B, C and the ordered sums ---------

SB_S = 4                  # SB_S in csrc/selective_scan_bwd.cu: states a lane
SB_CHANNELS = 64          # SB_CHANNELS: a block's channels
SB_SUM_SPLIT = 4          # SB_SUM_SPLIT: runs of channel groups a sum adds
LN2 = 0.6931471805599453


def _ex2(z):
    """exp2 with outputs below 2^-126 flushed to 0 (MUFU.EX2's .ftz)."""
    e = torch.exp2(z)
    return torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)


def _butterfly(v, dim, dists):
    """The kernel's reduce by halves as each holder sees it: at every
    distance a lane adds its partner's value to its own, in that order."""
    idx = torch.arange(v.shape[dim])
    for d in dists:
        v = v + v.index_select(dim, idx ^ d)
    return v


def _block_partials(v, lanes):
    """(B, Dp, NS) terms of a step -> (B, groups, NS): each 64-channel
    group's 16 partials (a warp's 4 channels summed by halves at lane
    distances 16 and 8, i.e. channel distances 16 / L and 8 / L) added in
    order (warp by warp, then the partial within the warp)."""
    b, dp, ns = v.shape
    wc = 32 // lanes                       # channels a warp
    pw = wc // 4                           # partials a warp
    d1, d2 = 16 // lanes, 8 // lanes
    v = v.reshape(b, dp // SB_CHANNELS, SB_CHANNELS // wc, wc, ns)
    v = _butterfly(v, 3, (d1, d2))
    part = torch.zeros(b, v.shape[1], v.shape[2], pw, ns)
    for s_ in range(SB_S):                 # the term a holder keeps
        for p_ in range(pw):
            holder = (s_ >> 1) * d1 + (s_ & 1) * d2 + p_
            part[..., p_, s_::SB_S] = v[:, :, :, holder, s_::SB_S]
    part = part.reshape(b, v.shape[1], -1, ns)
    acc = part[:, :, 0]
    for w in range(1, part.shape[2]):
        acc = acc + part[:, :, w]
    return acc


def _groups_sum(rows):
    """(B, groups, N) partials -> (B, N): SB_SUM_SPLIT runs of groups, each
    added in order, then ((run 0 + run 1) + (run 2 + run 3))."""
    groups = rows.shape[1]
    run = -(-groups // SB_SUM_SPLIT)
    runs = []
    for k in range(SB_SUM_SPLIT):
        lo, hi = k * run, min(groups, (k + 1) * run)
        acc = torch.zeros_like(rows[:, 0])
        if lo < hi:
            acc = rows[:, lo]
            for g in range(lo + 1, hi):
                acc = acc + rows[:, g]
        runs.append(acc)
    return _butterfly(torch.stack(runs, -1), -1, (1, 2))[..., 0]


def _lane_partials(terms, other):
    """A lane's sum of its 4 states' terms * other, fused, in state order:
    (B, Dp, NS) -> (B, Dp, L)."""
    b, dp, ns = terms.shape
    t4 = terms.reshape(b, dp, ns // SB_S, SB_S)
    o4 = other.reshape(b, dp, ns // SB_S, SB_S)
    acc = torch.zeros(b, dp, ns // SB_S)
    for s_ in range(SB_S):
        acc = _fma(t4[..., s_], o4[..., s_], acc)
    return acc


def selective_scan_bwd_segmented(x, dt, bmat, cmat, a, h0, dy, dhT=None):
    """``csrc/selective_scan_bwd.cu``'s arithmetic: (dx, ddt, dB, dC, da,
    dh0) in fp32 from fp32 operands, the forward's operands and
    cotangents."""
    b, t, di = x.shape
    n = bmat.shape[-1]
    ns = scan_kernel.padded_state(n)
    lanes = ns // SB_S
    groups = -(-di // SB_CHANNELS)
    dp = groups * SB_CHANNELS
    chunks = -(-t // scan_kernel.SAVE)
    pad_d = lambda z: torch.nn.functional.pad(z, (0, dp - di))
    pad_n = lambda z: torch.nn.functional.pad(z, (0, ns - n))
    xs, dts, dys = pad_d(x), pad_d(dt), pad_d(dy)
    bs, cs = pad_n(bmat), pad_n(cmat)
    a_pad = torch.nn.functional.pad(pad_n(a), (0, 0, 0, dp - di))
    a2 = a_pad * torch.tensor(LOG2E, dtype=torch.float32)
    h = torch.nn.functional.pad(pad_n(h0), (0, 0, 0, dp - di))
    dtx = dts * xs
    # A: each chunk walked forward (continuing the forward's states)
    states, dc_rows, decay, gloc = [], [], [], []
    for ck in range(chunks):
        pr, gl = torch.ones_like(h), torch.zeros_like(h)
        dt_sum = torch.zeros(b, dp, 1)
        for tt in range(ck * scan_kernel.SAVE,
                        min(t, (ck + 1) * scan_kernel.SAVE)):
            states.append(h)                                  # h_{t-1}
            al = _ex2(dts[:, tt, :, None] * a2)
            h = _fma(al, h, dtx[:, tt, :, None] * bs[:, tt, None, :])
            pr = pr * al
            gl = _fma(pr, dys[:, tt, :, None] * cs[:, tt, None, :], gl)
            dt_sum = dt_sum + dts[:, tt, :, None]
            dc_rows.append(_block_partials(dys[:, tt, :, None] * h, lanes))
        decay.append(_ex2(a2 * dt_sum))       # P: one exp of the exponents
        gloc.append(gl)
    # B: the gradient at each chunk's end, from the last
    g_end = [None] * chunks
    g_end[-1] = (torch.zeros_like(h) if dhT is None else
                 torch.nn.functional.pad(pad_n(dhT), (0, 0, 0, dp - di)))
    for ck in range(chunks - 2, -1, -1):
        g_end[ck] = _fma(decay[ck + 1], g_end[ck + 1], gloc[ck + 1])
    # C: each chunk swept back from its true G
    dx, ddt = torch.zeros(b, t, dp), torch.zeros(b, t, dp)
    db_rows = [None] * t
    da_parts = []
    for ck in range(chunks):
        g, da = g_end[ck], torch.zeros_like(h)
        for tt in reversed(range(ck * scan_kernel.SAVE,
                                 min(t, (ck + 1) * scan_kernel.SAVE))):
            gs = _fma(dys[:, tt, :, None], cs[:, tt, None, :], g)
            gp = gs * _ex2(dts[:, tt, :, None] * a2)
            qv = gp * states[tt]
            q = tt % lanes                       # the lane holding step tt
            px = _butterfly(_lane_partials(gs, bs[:, tt, None, :]
                                           .expand_as(gs)), -1,
                            [1 << l for l in range(lanes.bit_length() - 1)])
            pd = _butterfly(_lane_partials(qv, a2.expand_as(qv)), -1,
                            [1 << l for l in range(lanes.bit_length() - 1)])
            px, pd = px[..., q], pd[..., q]
            dx[:, tt] = px * dts[:, tt]
            ddt[:, tt] = _fma(px, xs[:, tt], pd * torch.tensor(
                LN2, dtype=torch.float32))
            db_rows[tt] = _block_partials(gs * dtx[:, tt, :, None], lanes)
            da = _fma(qv, dts[:, tt, :, None], da)
            g = gp
        da_parts.append(da)
        if ck == 0:
            dh0 = g
    db = torch.stack([_groups_sum(r) for r in db_rows], 1)[..., :n]
    dc = torch.stack([_groups_sum(r) for r in dc_rows], 1)[..., :n]
    da_sum = da_parts[0][0]
    for bb in range(b):
        for ck in range(chunks):
            if bb or ck:
                da_sum = da_sum + da_parts[ck][bb]
    return (dx[..., :di], ddt[..., :di], db, dc, da_sum[:di, :n],
            dh0[:, :di, :n])


def _scan_bwd_case(b, t, di, n, seed, underflow):
    ops_np = list(_scan_inputs(b, t, di, n, seed))
    if underflow:                 # exp(dt a) underflows to 0 there
        ops_np[1][:, ::5] = 50.0
        ops_np[4][::3] = -100.0
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(b, t, di)).astype(np.float32)
    dh = rng.normal(size=(b, di, n)).astype(np.float32)
    return ops_np, dy, dh


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("n", [7, 16])
@pytest.mark.parametrize("t", [64, 65, 128, 130])
def test_selective_scan_bwd_segmented_matches_vjp_and_plain(t, n, with_dh,
                                                            underflow):
    """The backward's order (A's forward walks with Gloc summed forward
    and P one exp2 of the chunk's summed exponent, B's carry, C's sweeps
    from the carried G; exp2 of the
    pre-scaled rate; the lane, channel and group sums in the kernel's
    trees and orders) at one chunk, one step past it, two chunks and two
    chunks and two steps, N = 7 (padded to 8) and 16, 130 channels (three
    64-channel groups, the last ragged), the final state's cotangent
    given and None, and with dt 50 at every 5th step and a -100 at every
    3rd channel (exp(dt a) underflows to 0), against ``jax.vjp`` of the
    reference's model scan (``_ssm_scan``) and the port's plain backward
    (``ref.selective_scan_bwd_ref``): each gradient within 1e-5 of its
    largest magnitude (fp32 sums in other orders)."""
    ops_np, dy, dh = _scan_bwd_case(1, t, 130, n, seed=t + n, underflow=
                                    underflow)
    dh = dh if with_dh else None
    ops = [torch.tensor(z) for z in ops_np]
    got = selective_scan_bwd_segmented(
        *ops, torch.tensor(dy), None if dh is None else torch.tensor(dh))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    (_, h_t), vjp = jax.vjp(_ssm_scan, *map(jnp.asarray, ops_np))
    want_jax = vjp((jnp.asarray(dy), jnp.zeros_like(h_t) if dh is None
                    else jnp.asarray(dh)))
    want_ref = ref.selective_scan_bwd_ref(
        *ops, torch.tensor(dy), None if dh is None else torch.tensor(dh))
    names = ("dx", "ddt", "dB", "dC", "da", "dh0")
    for want in (want_jax, want_ref):
        for name, g, w in zip(names, got, want):
            assert _err(g, w) <= 1e-5, name


@pytest.mark.parametrize("b,t,di,n", [(1, 1024, 8192, 16), (3, 77, 300, 7),
                                      (1, 200, 1024, 32), (2, 130, 8200, 16),
                                      (1, 129, 1024, 16)])
def test_selective_scan_bwd_scratch_is_the_wrappers(monkeypatch, b, t, di,
                                                    n):
    """``bwd_scratch_parts`` is what ``selective_scan_bwd_cuda`` allocates
    and hands the launch (the wrapper run on CPU tensors with the build's
    checks and library stubbed): the states at phase C's sub-chunk starts
    (every 16 steps, 8 at N <= 8), Gloc and P for each chunk but the
    first, the dB and dC partials per 64 channels and da's per (b, chunk);
    below the first design's 2 B ceil(Di / 16) T N + B Di N floats at
    jamba's training microbatch."""
    parts = scan_kernel.bwd_scratch_parts(b, t, di, n)
    chunks = -(-t // 64)
    subs = 8 if n <= 8 else 4
    groups = -(-di // 64)
    assert parts == {"checkpoints": b * chunks * (subs - 1) * di * n,
                     "g_carry": b * (chunks - 1) * di * n,
                     "decay": b * (chunks - 1) * di * n,
                     "db_partials": b * groups * t * n,
                     "dc_partials": b * groups * t * n,
                     "da_partials": b * chunks * di * n}
    if (b, t, di, n) == (1, 1024, 8192, 16):
        assert 4 * (parts["db_partials"] + parts["dc_partials"]) <= 16.8e6
        assert sum(parts.values()) < 2 * b * -(-di // 16) * t * n + b * di * n
    seen = {}

    class Lib:
        @staticmethod
        def selective_scan_bwd_launch(*args):
            seen["scratch"] = args[-2]
            return 0
    monkeypatch.setattr(scan_kernel.build, "require", lambda *a: None)
    monkeypatch.setattr(scan_kernel.build, "load", lambda name: Lib)
    monkeypatch.setattr(scan_kernel.build, "stream_ptr", lambda x: 0)
    sizes = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        sizes[out.data_ptr()] = out.numel()
        return out
    monkeypatch.setattr(torch, "empty", empty)
    small = (1, min(t, 130), 64, n)          # the wrapper's own shapes
    bb, tt, dd, nn = small if b * t * di > 10 ** 6 else (b, t, di, n)
    x = torch.zeros(bb, tt, dd)
    bm = torch.zeros(bb, tt, nn)
    states = torch.zeros(bb, max(-(-tt // 64) - 1, 0), dd, nn)
    scan_kernel.selective_scan_bwd_cuda(x, x, bm, bm, torch.zeros(dd, nn),
                                        torch.zeros(bb, dd, nn), states, x)
    assert sizes[seen["scratch"]] == sum(
        scan_kernel.bwd_scratch_parts(bb, tt, dd, nn).values())
