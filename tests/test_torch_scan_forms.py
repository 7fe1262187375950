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
from repro.models.rwkv6 import wkv6_chunked
from repro_torch.kernels import ref
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
