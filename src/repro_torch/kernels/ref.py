"""Plain PyTorch versions of the hand-written kernels.

Direct transcriptions of ``repro.kernels.ref`` — the yardstick the CUDA
kernels are held against on the card, and what ``kernels/ops.py`` runs
for a tensor on the CPU.  Sums over clients go through a one-hot matmul
(never float atomics), so every result here is run-to-run deterministic.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from repro_torch.fl.client import dataset_loss_packed

NUM_OUT = 9
NEG_INF = -1e30          # the TPU kernel's masked score: finite


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an fp32 scalar on ``like``'s device: comparisons
    against it happen in fp32, as JAX's weakly typed floats do."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def fuzzy_eval_ref(x: torch.Tensor, means: torch.Tensor,
                   sigmas: torch.Tensor, rule_table: torch.Tensor,
                   rule_levels: torch.Tensor, level_centers: torch.Tensor,
                   normalize: bool = False,
                   col_maxima: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Mamdani inference: x (P, 4) in [0, 1] -> evaluations (P,).

    Gaussian memberships (4 variables x 3 levels), min-conjunction over
    the 81 rules, max-aggregation per output level, COG over the level
    centers.  ``normalize=True`` takes raw columns and applies Eq. 8
    (x / column max, clipped to [0, 1]) first; ``col_maxima`` (4,)
    divides by those maxima instead.  x (seeds, P, 4) evaluates each
    seed on its own (its own maxima, or its row of ``col_maxima``
    (seeds, 4)) -> (seeds, P)."""
    if x.dim() == 3:
        return torch.stack([fuzzy_eval_ref(
            x[i], means, sigmas, rule_table, rule_levels, level_centers,
            normalize, None if col_maxima is None else col_maxima[i])
            for i in range(x.shape[0])])
    if col_maxima is not None:
        x = torch.clamp(x / torch.clamp(col_maxima, min=1e-9), 0.0, 1.0)
    elif normalize:                                          # Eq. 8
        maxima = torch.clamp(x.max(dim=0).values, min=1e-9)
        x = torch.clamp(x / maxima, 0.0, 1.0)
    d = (x[..., :, None] - means) / sigmas
    mu = torch.exp(-0.5 * d * d)                             # (P, V, 3)
    table = rule_table.to(x.device).long()                   # (R, V)
    levels = rule_levels.to(x.device).long()                 # (R,)
    v = torch.arange(table.shape[1], device=x.device)
    firing = mu[:, v[None, :], table].min(dim=-1).values     # (P, R)
    beta = torch.stack([firing[:, levels == j].max(dim=1).values
                        for j in range(NUM_OUT)], dim=1)     # (P, 9)
    num = (beta * level_centers).sum(-1)
    den = torch.clamp(beta.sum(-1), min=1e-9)
    return num / den


@contextlib.contextmanager
def _one_thread(t: torch.Tensor):
    """Torch's (and so MKL's) intra-op threads at one inside the block,
    for a tensor on the CPU."""
    n = torch.get_num_threads()
    if t.device.type == "cpu" and n > 1:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        if torch.get_num_threads() != n:
            torch.set_num_threads(n)


def cohort_gemm_ref(a: torch.Tensor, b: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    rowsum: bool = False):
    """``sum_r a[:, :, r] @ b[:, :, r] (+ bias)`` for a (Z1, Z2, R, M,
    K) and b (Z1, Z2, R, K, N) views -> a contiguous (Z1, Z2, M, N), and
    with ``rowsum`` also a's sums over (r, k) (a product with a broadcast
    one) -> ``(c, (Z1, Z2, M))``: ``torch.matmul``, one call per cohort
    member (Z2) on fresh contiguous copies of its operands, on the CPU
    at one intra-op thread, then the R products added in order.  A
    library GEMM picks its blocking, split-K and threading by the batch
    count (cuBLAS; MKL) and by the threads it is given (MKL splits a
    skinny product's K across threads, and may take fewer than it was
    given), so one call over the cohort gave a member other bits alone
    than in a cohort, at one thread count than at another, and in one
    process than in another (ROADMAP C12, C14); a member's call sees
    the same shapes, strides, alignment and threads whatever Z2 and the
    thread count are."""
    fresh = [(a[:, i].clone(memory_format=torch.contiguous_format),
              b[:, i].clone(memory_format=torch.contiguous_format))
             for i in range(a.shape[1])]
    with _one_thread(a):
        prods = [torch.matmul(x, y) for x, y in fresh]
    prod = torch.stack(prods, dim=1)
    out = prod[:, :, 0]
    for r in range(1, prod.shape[2]):            # R in order, elementwise
        out = out + prod[:, :, r]
    out = (out + bias if bias is not None else out).contiguous()
    if not rowsum:
        return out
    ones = a.new_ones(()).expand(*a.shape[:3], a.shape[4], 1)
    return out, cohort_gemm_ref(a, ones)[..., 0]


def probe_loss_ref(params, images: torch.Tensor, labels: torch.Tensor,
                   seg: torch.Tensor, counts: torch.Tensor, n_clients: int,
                   chunk: int = 4096) -> torch.Tensor:
    """Eq. 7 over a packed sample tensor -> (N,) mean losses: the
    unfused prefix's probe (``fl/client.py::dataset_loss_packed``) in
    forward passes of ``chunk`` samples, which bounds memory and does
    not change the arithmetic per sample.  Images (seeds, S, 28, 28, 1)
    give every operand a leading axis of seeds: (seeds, N), each seed
    on its own."""
    if images.dim() == 5:
        return torch.stack([probe_loss_ref(
            {k: v[i] for k, v in params.items()}, images[i], labels[i],
            seg[i], counts[i], n_clients, chunk)
            for i in range(images.shape[0])])
    return dataset_loss_packed(params, images, labels, seg, counts,
                               n_clients, batch=chunk)


def probe_fuzzy_ref(params, images, labels, seg, counts, aux, means,
                    sigmas, rule_table, rule_levels, level_centers,
                    n_clients: int,
                    col_maxima: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection hot path in one transcription: Eq. 7 probe -> raw
    features [SQ, TA, CC, LF] -> Eq. 8 (in-batch maxima or external
    ``col_maxima`` (4,)) -> Mamdani.  Returns ``(feats (N, 4), evals)``.
    Images (seeds, S, 28, 28, 1) give every operand but the Mamdani set
    a leading axis of seeds: each seed's Eq. 8 over its own clients,
    ``(feats (seeds, N, 4), evals (seeds, N))``."""
    if images.dim() == 5:
        outs = [probe_fuzzy_ref(
            {k: v[i] for k, v in params.items()}, images[i], labels[i],
            seg[i], counts[i], aux[i], means, sigmas, rule_table,
            rule_levels, level_centers, n_clients,
            None if col_maxima is None else col_maxima[i])
            for i in range(images.shape[0])]
        return (torch.stack([f for f, _ in outs]),
                torch.stack([e for _, e in outs]))
    lf = probe_loss_ref(params, images, labels, seg, counts, n_clients)
    feats = torch.cat([aux.float(), lf[:, None]], dim=1)
    if col_maxima is None:
        return feats, fuzzy_eval_ref(feats, means, sigmas, rule_table,
                                     rule_levels, level_centers,
                                     normalize=True)
    return feats, fuzzy_eval_ref(feats, means, sigmas, rule_table,
                                 rule_levels, level_centers,
                                 col_maxima=col_maxima)


def neighbor_elect_ref(pos: torch.Tensor, evals: torch.Tensor, *,
                       comm_range: float, top_m: int, e_tau: float,
                       rows: int = 4096) -> torch.Tensor:
    """Dense DCS election (paper Alg. 1): vehicle i is selected iff
    eval_i >= E_tau and fewer than ``top_m`` in-range vehicles at or
    above E_tau are strictly better (lower index wins ties).  All
    comparisons in fp32.  Returns int32 (N,) 0/1; ``rows`` bounds the
    memory of one block of the (N, N) comparison.  Leading axes (seeds)
    are fleets of their own: (..., N) in, (..., N) out."""
    if pos.dim() > 1:
        n = pos.shape[-1]
        return torch.stack([
            neighbor_elect_ref(p, e, comm_range=comm_range, top_m=top_m,
                               e_tau=e_tau, rows=rows)
            for p, e in zip(pos.reshape(-1, n), evals.reshape(-1, n))
        ]).reshape(pos.shape)
    n = pos.shape[0]
    cr, et = _f32(comm_range, pos), _f32(e_tau, pos)
    idx = torch.arange(n, device=pos.device)
    cand = evals[None, :] >= et
    out = []
    for s in range(0, n, rows):
        pi, ei, ii = pos[s:s + rows, None], evals[s:s + rows, None], \
            idx[s:s + rows, None]
        valid = (torch.abs(pi - pos[None, :]) <= cr) & cand
        better = (evals[None, :] > ei) | ((evals[None, :] == ei)
                                          & (idx[None, :] < ii))
        out.append((valid & better).sum(dim=1))
    n_better = torch.cat(out)
    return ((evals >= et) & (n_better < top_m)).to(torch.int32)


def windowed_counts_ref(sp: torch.Tensor, se: torch.Tensor,
                        sg: torch.Tensor, *, comm_range: float,
                        e_tau: float, n_valid: int, window: int,
                        block: int) -> torch.Tensor:
    """Better-neighbour counts over position-sorted (M,) arrays padded to
    a multiple of ``block`` (sentinels pos 1e18 / ev -1e18 / id >=
    ``n_valid``) -> (M,) int32.

    The candidate set is the Pallas kernel's, block-granular: row block
    ``ib`` visits candidate blocks ``[ib - hops, ib + hops]`` clipped to
    the array, ``hops = ceil(window / block)``, each once.  It is wider
    than ``window`` ranks; the two agree wherever ``window_coverage``
    certifies the window."""
    m = sp.shape[0]
    nb = m // block
    hops = min(-(-int(window) // block), max(nb - 1, 0))
    cr, et = _f32(comm_range, sp), _f32(e_tau, sp)
    p, e, g = (t.reshape(nb, block) for t in (sp, se, sg))
    ib = torch.arange(nb, device=sp.device)
    counts = torch.zeros(nb, block, dtype=torch.int32, device=sp.device)
    for off in range(-hops, hops + 1):
        tgt = ib + off
        inb = ((tgt >= 0) & (tgt < nb))[:, None, None]
        tc = tgt.clamp(0, nb - 1)
        pj, ej, gj = p[tc][:, None, :], e[tc][:, None, :], g[tc][:, None, :]
        pi, ei, gi = p[:, :, None], e[:, :, None], g[:, :, None]
        ok = (torch.abs(pi - pj) <= cr) & (ej >= et) & (gj < n_valid)
        better = (ej > ei) | ((ej == ei) & (gj < gi))
        counts += (ok & better & inb).sum(dim=2, dtype=torch.int32)
    return counts.reshape(m)


def windowed_elect_ref(pos: torch.Tensor, evals: torch.Tensor, *,
                       comm_range: float, top_m: int, e_tau: float,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle of the windowed election's contract (tests only):
    ``(mask, overflow)`` with the dense election's mask, and ``overflow``
    1 iff some vehicle has a valid in-range neighbour more than
    ``window`` position-sorted ranks away.  A windowed election must give
    this mask wherever its own flag is 0, and flag wherever this one
    flags."""
    n = pos.shape[0]
    mask = neighbor_elect_ref(pos, evals, comm_range=comm_range,
                              top_m=top_m, e_tau=e_tau)
    order = torch.argsort(pos, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=pos.device)
    rank[order] = torch.arange(n, device=pos.device)
    validc = ((torch.abs(pos[:, None] - pos[None, :])
               <= _f32(comm_range, pos))
              & (evals[None, :] >= _f32(e_tau, pos)))
    far = torch.abs(rank[:, None] - rank[None, :]) > window
    return mask, (validc & far).any().to(torch.int32)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence, one step at a time, in fp32.

    r, k, v, w: (B, T, H, N) of any float dtype; u: (H, N); s0:
    (B, H, N, N), indexed key x value.  Per step
    ``y_t = r_t . (S + u (x) k_t v_t^T)`` and ``S <- diag(w_t) S +
    k_t v_t^T``.  Returns ``(y (B, T, H, N) fp32, sT (B, H, N, N)
    fp32)``."""
    r, k, v, w = (z.float() for z in (r, k, v, w))
    u, s = u.float(), s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               s + u[..., :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(r)
    return y, s


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 dy: torch.Tensor, dsT: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``wkv6_ref``'s ``(y, sT)`` under the cotangents
    ``dy`` (B, T, H, N) and ``dsT`` (B, H, N, N; None: zeros), by an
    explicit reverse sweep in fp32.  The states S_{t-1} are rebuilt by
    the forward recurrence (never by dividing by w); then, from dS =
    dsT, per step t from the last:

        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = dS v_t + r_t u (v_t . dy_t)
        dv_t = dS^T k_t + (r_t . (u k_t)) dy_t
        dw_t[i] = sum_j dS[i, j] S_{t-1}[i, j]
        du += r_t k_t (v_t . dy_t)
        dS <- diag(w_t) dS + r_t dy_t^T

    with dS the gradient of the state after step t; ds0 is the last dS.
    Returns ``(dr, dk, dv, dw, du (H, N), ds0)``: dr, dk and dv in r's
    dtype, dw in w's, du and ds0 fp32."""
    rf, kf, vf, wf, dyf = (z.float() for z in (r, k, v, w, dy))
    uf, s = u.float(), s0.float()
    t_len = r.shape[1]
    states = []                                  # S_{t-1} for each t
    for t in range(t_len):
        states.append(s)
        s = (wf[:, t, :, :, None] * s
             + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    ds = torch.zeros_like(s) if dsT is None else dsT.float().clone()
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(rf[:, 0])               # (B, H, N)
    for t in reversed(range(t_len)):
        rt, kt, vt, wt, dyt = (z[:, t] for z in (rf, kf, vf, wf, dyf))
        vdy = (vt * dyt).sum(-1, keepdim=True)    # (B, H, 1)
        dr[:, t] = (torch.einsum("bhij,bhj->bhi", states[t], dyt)
                    + uf * kt * vdy)
        dk[:, t] = torch.einsum("bhij,bhj->bhi", ds, vt) + rt * uf * vdy
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", ds, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
        dw[:, t] = (ds * states[t]).sum(-1)
        du = du + rt * kt * vdy
        ds = wt[..., :, None] * ds + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.sum(0), ds)



def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor,
                       a: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan, one step at a time, in fp32.

    x, dt: (B, T, Di); bmat, cmat: (B, T, N), of any float dtype; a:
    (Di, N); h0: (B, Di, N).  Per step ``h = exp(dt_t a) h + (dt_t x_t)
    (x) B_t`` and ``y_t = h . C_t``, with dt and x cast to fp32 before
    their product, as the model's scan (``repro/models/mamba.py:68-76``)
    and ``selective_scan_pallas`` do (the reference's own oracle,
    ``repro/kernels/ref.py::selective_scan_ref``, multiplies them in the
    input dtype first).  Returns ``(y (B, T, Di) fp32, hT (B, Di, N)
    fp32)``."""
    dtf = dt.float()
    dtx = dtf * x.float()
    bf, cf = bmat.float(), cmat.float()
    a, h = a.float(), h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dtf[:, t, :, None] * a) * h
             + dtx[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(dtx)
    return y, h


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           bmat: torch.Tensor, cmat: torch.Tensor,
                           a: torch.Tensor, h0: torch.Tensor,
                           dy: torch.Tensor,
                           dhT: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``selective_scan_ref``'s ``(y, hT)`` under the
    cotangents ``dy`` (B, T, Di) and ``dhT`` (B, Di, N; None: zeros), by
    an explicit reverse sweep in fp32.  The states h_{t-1} are rebuilt by
    the forward recurrence (never by dividing by exp(dt a), which
    underflows); then, from g = dhT, per step t from the last, with
    alpha = exp(dt_t a) and q = g h_{t-1} alpha:

        g += dy_t C_t                       (the gradient of h_t)
        dC_t = sum_d dy_t h_t,  dB_t = sum_d g (dt_t x_t)
        dx_t = dt_t sum_n g B_t
        ddt_t = x_t sum_n g B_t + sum_n q a
        da += q dt_t
        g <- alpha g

    dh0 is the last g.  Returns ``(dx, ddt, dB, dC, da (Di, N), dh0)``:
    dx, ddt, dB and dC in their inputs' dtypes, da and dh0 fp32."""
    dtf, xf = dt.float(), x.float()
    dtx = dtf * xf
    bf, cf, dyf = bmat.float(), cmat.float(), dy.float()
    a, h = a.float(), h0.float()
    t_len = x.shape[1]
    states = [h]                                  # h_{t-1}, then hT
    for t in range(t_len):
        h = (torch.exp(dtf[:, t, :, None] * a) * h
             + dtx[:, t, :, None] * bf[:, t, None, :])
        states.append(h)
    g = torch.zeros_like(h) if dhT is None else dhT.float().clone()
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(xf)
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros_like(a)
    for t in reversed(range(t_len)):
        alpha = torch.exp(dtf[:, t, :, None] * a)
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        dc[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], dyf[:, t])
        db[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
        gb = (g * bf[:, t, None, :]).sum(-1)
        q = g * states[t] * alpha
        dx[:, t] = gb * dtf[:, t]
        ddt[:, t] = gb * xf[:, t] + (q * a).sum(-1)
        da = da + (q * dtf[:, t, :, None]).sum(0)
        g = alpha * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(bmat.dtype),
            dc.to(cmat.dtype), da, g)


def _attention_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                      window: int, prefix_len: int) -> torch.Tensor:
    """Scaled, masked scores (B, Hkv, G, Sq, Skv) in fp32 (fp64 for fp64
    inputs) over the natural positions 0..S-1 of q and kv, with
    ``flash_attention_pallas``'s mask: causal first, then ``window``
    narrowing it and ``prefix_len`` widening it (both only when causal),
    dropped scores ``NEG_INF``.  q head h reads kv head ``h // G``."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct).reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(ct)) * (
        1.0 / math.sqrt(dh))
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        ok = kp <= qp
        if window:
            ok &= (qp - kp) < window
        if prefix_len:
            ok |= kp < prefix_len
        s = s.masked_fill(~ok, NEG_INF)
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        prefix_len: int = 0) -> torch.Tensor:
    """Masked softmax attention in fp32 (``_attention_scores``' mask).

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh), q head h reading kv
    head ``h // (Hq // Hkv)`` -> (B, Sq, Hq, Dh) in q's dtype."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len)[0]


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, prefix_len: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_ref`` and each q row's log-sum-exp of its
    scaled, masked scores -> ``(out (B, Sq, Hq, Dh) in q's dtype, lse
    (B, Hq, Sq) fp32)`` (fp64 for fp64 inputs, as ``gradcheck`` takes
    them)."""
    b, sq, hq, dh = q.shape
    s = _attention_scores(q, k, causal=causal, window=window,
                          prefix_len=prefix_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(s.dtype))
    lse = torch.logsumexp(s, dim=-1).reshape(b, hq, sq)
    return out.reshape(b, sq, hq, dh).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            prefix_len: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention_lse_ref``'s
    output ``o`` under the cotangent ``do``, by the explicit formulas in
    fp32 (fp64 for fp64 inputs), with scale = 1 / sqrt(Dh):

        D = rowsum(dO * O),  P = exp(S scale - lse),  dV = P^T dO,
        dP = dO V^T,  dS = P * (dP - D),  dQ = scale dS K,
        dK = scale dS^T Q,

    dK and dV summed over each GQA group's q heads; a dropped score is
    ``NEG_INF``, so its P is 0.  Returns the inputs' dtypes."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = _attention_scores(q, k, causal=causal, window=window,
                          prefix_len=prefix_len)
    ct = s.dtype
    scale = 1.0 / math.sqrt(dh)
    p = torch.exp(s - lse.to(ct).reshape(b, hkv, g, sq)[..., None])
    dof = do.to(ct).reshape(b, sq, hkv, g, dh)
    qf = q.to(ct).reshape(b, sq, hkv, g, dh)
    delta = (dof * o.to(ct).reshape(b, sq, hkv, g, dh)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.to(ct))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(ct)) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
