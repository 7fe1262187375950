"""CPU emulation of the two small kernels' Hopper designs, without a card.

``csrc/windowed_counts.cu`` spreads a row block's candidate run over the
warps of CTAs of 32 R rows: it stages the run in tiles with the
candidate-only half of the DCS predicate folded into the position (NaN
when a candidate cannot count), skips a sub-chunk of 32 candidates when
its position span is out of DSRC range of the rows' span, and sums the
warps' partial counts.  ``csrc/fuzzy_eval.cu`` folds Eq. 8's column
maxima over every row in each CTA (a small grid) or per CTA and then
over the CTAs (a cooperative grid), and evaluates the rules sorted by
output level from the pairwise minima of (SQ, TA) and (CC, LF), a
participant's rules split over up to 8 warps.  The helpers here repeat
those partitions and orders with PyTorch on the CPU, so the claims the
kernels rest on are shown for the arithmetic itself: the counts are
bit-equal to ``windowed_counts_pallas`` in interpret mode (the prune is
exact), and the evaluations are bit-equal to the table-order Mamdani
fold for every split and within the plain version's tolerance of
``fuzzy_eval_pallas``.  The card tests (``tests/test_torch_gpu.py``) and
``chip_smoke.py`` hold the kernels themselves against the plain
versions.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fuzzy import FuzzyEvaluator
from repro.kernels.fuzzy_eval import fuzzy_eval_pallas
from repro.kernels.neighbor_elect import windowed_counts_pallas
from repro_torch.core import elect
from repro_torch.core.rules import build_rule_table
from repro_torch.kernels import fuzzy_eval as fe
from repro_torch.kernels import ref
from torch_threads import torch_intra_op_threads  # noqa: F401

CR, E_TAU = 200.0, 30.0
WC_WARPS, WC_TILE, WC_SUB = 8, 1536, 32     # csrc/windowed_counts.cu
FE_THREADS = 256                            # csrc/fuzzy_eval.cu
NAN = float("nan")
f32 = functools.partial(torch.tensor, dtype=torch.float32)


# --- windowed_counts: the partition, the staging and the prune -------------


def _span(x: torch.Tensor):
    """fminf / fmaxf folds: NaN drops out, all-NaN stays NaN."""
    ok = x[~torch.isnan(x)]
    if ok.numel() == 0:
        return f32(NAN), f32(NAN)
    return ok.min(), ok.max()


def windowed_counts_partition(sp, se, sg, *, comm_range, e_tau, n_valid,
                              window, block, rows_per_lane):
    """``csrc/windowed_counts.cu``'s counts, CTA by CTA: ``(counts (M,)
    int32, sub-chunks pruned, sub-chunks swept)``."""
    m = sp.shape[0]
    nb = m // block
    hops = min(-(-window // block), nb)
    cr, et = f32(comm_range), f32(e_tau)
    rows = 32 * rows_per_lane
    staged = torch.where((se >= et) & (sg < n_valid), sp, f32(NAN))
    out = torch.zeros(m, dtype=torch.int32)
    pruned = swept = 0
    for ib in range(nb):
        c_begin = max(ib - hops, 0) * block
        c_end = (min(ib + hops, nb - 1) + 1) * block
        for r0 in range(ib * block, (ib + 1) * block, rows):
            r1 = min(r0 + rows, (ib + 1) * block)
            pi, ei, gi = sp[r0:r1, None], se[r0:r1, None], sg[r0:r1, None]
            pmin, pmax = _span(sp[r0:r1])
            partial = torch.zeros(WC_WARPS, r1 - r0, dtype=torch.int32)
            for t0 in range(c_begin, c_end, WC_TILE):
                t1 = min(t0 + WC_TILE, c_end)
                for s, c0 in enumerate(range(t0, t1, WC_SUB)):
                    c1 = min(c0 + WC_SUB, t1)
                    lo, hi = _span(staged[c0:c1])
                    if (torch.isnan(lo) or lo - pmax > cr
                            or pmin - hi > cr):
                        pruned += 1
                        continue
                    swept += 1
                    pj, ej, gj = staged[None, c0:c1], se[None, c0:c1], \
                        sg[None, c0:c1]
                    near = torch.abs(pi - pj) <= cr
                    better = (ej > ei) | ((ej == ei) & (gj < gi))
                    partial[s % WC_WARPS] += (near & better).sum(
                        1, dtype=torch.int32)
            out[r0:r1] = partial.sum(0, dtype=torch.int32)
    return out, pruned, swept


def _fleet(m, block, seed, kind, road):
    """Sorted and sentinel-padded as ``sorted_window_counts`` pads:
    ``uniform`` forces pairs exactly ``comm_range`` apart, duplicate
    positions and tied evaluations (integers and halves are exact in
    fp32); ``clustered`` packs half the fleet into 150 m."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, road, m).astype(np.float32)
    ev = rng.uniform(0, 100, m).astype(np.float32)
    pos[:8] = [100, 300, 300, 500, 100.5, 300.5, 700, 900]
    ev[:8] = [50, 50, 50, 29.999, 30, 30, 80, 80]
    ev[8:40] = 50.0
    if kind == "clustered":
        pos[m // 2:] = rng.uniform(0, 150, m - m // 2)
    order = np.argsort(pos, kind="stable")
    pad = -(-m // block) * block - m
    return (np.concatenate([pos[order], np.full(pad, elect.SENT_POS)])
            .astype(np.float32),
            np.concatenate([ev[order], np.full(pad, elect.SENT_EV)])
            .astype(np.float32),
            np.concatenate([order, np.full(pad, m)]).astype(np.int32))


# (fleet size, block, window, kind, road m): the large fleet's block and
# window (elect_window at 1 vehicle per metre) on 2048 of its vehicles,
# a clustered fleet, blocks of 32 and 96, and a dense road where sorted
# neighbours sit exactly comm_range apart
WINDOW_CASES = [(2048, 128, 616, "uniform", 2048.0),
                (2048, 128, 616, "clustered", 2048.0),
                (960, 96, 200, "uniform", 960.0),
                (320, 32, 50, "uniform", 320.0),
                (1000, 128, 300, "uniform", 750.0)]


@functools.lru_cache(maxsize=None)
def _window_case(i):
    m, block, window, kind, road = WINDOW_CASES[i]
    sp, se, sg = _fleet(m, block, seed=i, kind=kind, road=road)
    kw = dict(comm_range=CR, e_tau=E_TAU, n_valid=m, window=window,
              block=block)
    want = np.asarray(windowed_counts_pallas(
        jnp.asarray(sp), jnp.asarray(se), jnp.asarray(sg), interpret=True,
        **kw))
    return (torch.tensor(sp), torch.tensor(se), torch.tensor(sg)), kw, want


@pytest.mark.parametrize("rows_per_lane", [1, 4])
@pytest.mark.parametrize("case", range(len(WINDOW_CASES)))
def test_windowed_partition_bit_equal_to_pallas(case, rows_per_lane):
    """Per-warp partial counts over pruned sub-chunks sum to the Pallas
    kernel's counts bit for bit (and the plain version's); the prune
    skips sub-chunks wherever the window is wider than the range."""
    (sp, se, sg), kw, want = _window_case(case)
    got, pruned, swept = windowed_counts_partition(
        sp, se, sg, rows_per_lane=rows_per_lane, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.windowed_counts_ref(sp, se, sg, **kw).numpy(), want)
    assert swept > 0 and int(got.sum()) > 0
    if WINDOW_CASES[case][3] == "uniform" and kw["window"] > 2 * CR:
        assert pruned > 0


def test_windowed_prune_keeps_pairs_at_exactly_comm_range():
    """Two vehicles exactly comm_range apart in different sub-chunks,
    every other candidate under E_tau: the sub-chunks' distance equals
    comm_range, the prune must not skip it, and the pair counts."""
    m, block = 64, 32
    sp = torch.cat([f32([0.0] * 31 + [100.0]),
                    f32([300.0] + [1000.0 + i for i in range(31)])])
    se = torch.cat([f32([20.0] * 31 + [40.0]), f32([90.0] + [10.0] * 31)])
    sg = torch.arange(m, dtype=torch.int32)
    kw = dict(comm_range=CR, e_tau=E_TAU, n_valid=m, window=32, block=block)
    got, _, _ = windowed_counts_partition(sp, se, sg, rows_per_lane=1, **kw)
    want = ref.windowed_counts_ref(sp, se, sg, **kw)
    assert torch.equal(got, want) and int(want[31]) == 1


def _order_key(e, g):
    """``wc_key`` in ``csrc/windowed_counts.cu``: (ev's bits mapped to an
    order-preserving uint32, -0 as +0) << 32 | the id's signed order
    reversed; a NaN row (``wc_row_key``) takes the greatest key."""
    b = e.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = np.where(b == 0x80000000, 0, b)
    ev = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    gid = g.astype(np.int32).view(np.uint32).astype(np.uint64) ^ 0x80000000
    return (ev << 32) | (~gid & 0xFFFFFFFF)


def test_order_key_compare_is_the_better_predicate():
    """``kj > ki`` is ``ej > ei or (ej == ei and gj < gi)`` for every
    candidate that can count (NaN never can) and every row, NaN rows
    included (nothing beats them): ties, -0 against +0, infinities,
    subnormals, sentinels, negative and extreme ids."""
    evs = np.array([-np.inf, -1e18, -1.5, -0.0, 0.0, 1e-45, 2.5, 29.999, 30,
                    50, 1e18, np.inf], np.float32)
    ids = np.array([-2 ** 31, -3, -1, 0, 1, 7, 4096, 2 ** 31 - 1], np.int32)
    e, g = (a.ravel() for a in np.meshgrid(evs, ids, indexing="ij"))
    kj = _order_key(e, g)
    for ei, gi in [*zip(e, g), (np.float32(np.nan), np.int32(0))]:
        ki = (np.uint64(2 ** 64 - 1) if np.isnan(ei)
              else _order_key(np.array([ei]), np.array([gi]))[0])
        with np.errstate(invalid="ignore"):
            better = (e > ei) | ((e == ei) & (g < gi))
        np.testing.assert_array_equal(kj > ki, better)


# --- fuzzy_eval: one pass, level-sorted rules, split warps ----------------


def _mamdani():
    ev = FuzzyEvaluator()
    return (np.asarray(ev.cfg.means, np.float32),
            np.asarray(ev.cfg.sigmas, np.float32),
            np.asarray(ev.level_centers, np.float32))


def _memberships(v, means, sigmas):
    d = (v[:, :, None] - means) / sigmas
    return torch.exp(-0.5 * d * d)                    # (P, 4, 3)


def _cog(beta, centers):
    """Level order, each product and sum rounded apart (no FMA)."""
    num = torch.zeros(beta.shape[0])
    den = torch.zeros(beta.shape[0])
    for j in range(beta.shape[1]):
        num = num + centers[j] * beta[:, j]
        den = den + beta[:, j]
    return num / torch.clamp(den, min=1e-9)


def _scaled(x, normalize, ctas):
    """Eq. 8 as the kernel folds it: each of ``ctas`` CTAs the maxima of
    the rows it strides over (256 a stride), then the CTAs' maxima."""
    if not normalize:
        return x
    owner = (torch.arange(x.shape[0]) // FE_THREADS) % ctas
    part = torch.stack([x[owner == b].max(0).values if (owner == b).any()
                        else torch.full((4,), -np.inf) for b in range(ctas)])
    inv = 1.0 / torch.clamp(part.max(0).values, min=1e-9)
    return torch.clamp(x * inv, 0.0, 1.0)


def fuzzy_eval_single_pass(x, means, sigmas, by_level, centers, *,
                           normalize, split, ctas=3):
    """``csrc/fuzzy_eval.cu``'s order: the maxima, then per participant
    the pairwise minima and, per level, ``split`` slices of its rules
    folded with max."""
    mu = _memberships(_scaled(x, normalize, ctas), means, sigmas)
    pairs = torch.cat([
        torch.minimum(mu[:, 0, :, None], mu[:, 1, None, :]).transpose(1, 2)
        .reshape(-1, 9),
        torch.minimum(mu[:, 2, :, None], mu[:, 3, None, :]).transpose(1, 2)
        .reshape(-1, 9)], dim=1)                      # index lo + 3 hi
    n_rules = by_level.shape[0] - 10
    codes, starts = by_level[:n_rules], by_level[n_rules:]
    beta = torch.zeros(x.shape[0], 9)
    for j in range(9):
        for s in range(split):
            part = torch.zeros(x.shape[0])
            for r in range(int(starts[j]) + s, int(starts[j + 1]), split):
                c = int(codes[r])
                a = (c & 3) + 3 * ((c >> 2) & 3)
                b = 9 + ((c >> 4) & 3) + 3 * ((c >> 6) & 3)
                part = torch.maximum(part, torch.minimum(pairs[:, a],
                                                         pairs[:, b]))
            beta[:, j] = torch.maximum(beta[:, j], part)
    return _cog(beta, centers)


def mamdani_table_order(x, means, sigmas, table, levels, centers):
    """``mamdani.cuh``'s ``mamdani_eval``: rules in the table's order,
    min over the four antecedents left to right, max into the level."""
    mu = _memberships(x, means, sigmas)
    beta = torch.zeros(x.shape[0], 9)
    for (t0, t1, t2, t3), lv in zip(table.tolist(), levels.tolist()):
        f = torch.minimum(torch.minimum(torch.minimum(
            mu[:, 0, t0], mu[:, 1, t1]), mu[:, 2, t2]), mu[:, 3, t3])
        beta[:, lv] = torch.maximum(beta[:, lv], f)
    return _cog(beta, centers)


def _fuzzy_inputs(p, normalize, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (p, 4)).astype(np.float32)
    x[:3] = [[0, 0, 0, 0], [1, 1, 1, 1], [0.5, 0.15, 0.85, 1.0]]
    if normalize:
        x = x * np.array([4500, 3e6, 1.0, 2.5], np.float32)
    return x


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_level_sorted_split_rules_are_mamdani_eval_bit_for_bit(split):
    """min and max are exact in any order and grouping: the level-sorted
    pass over pairwise minima, split over warps, gives the table-order
    fold's evaluations bit for bit."""
    means, sigmas, centers = (torch.tensor(a) for a in _mamdani())
    table, levels = build_rule_table()
    x = torch.tensor(_fuzzy_inputs(300, False))
    by_level = fe.rules_by_level(table, levels, torch.device("cpu"))
    got = fuzzy_eval_single_pass(x, means, sigmas, by_level, centers,
                                 normalize=False, split=split)
    want = mamdani_table_order(x, means, sigmas, table, levels, centers)
    assert torch.equal(got, want)


@pytest.mark.parametrize("normalize,ctas", [(False, 1), (True, 1),
                                             (True, 3)])
@pytest.mark.parametrize("p", [30, 700])
def test_single_pass_fuzzy_eval_matches_pallas(p, normalize, ctas):
    """The maxima folded by one CTA over every row (a small grid) or
    over 3 CTAs' strides and then the CTAs (a cooperative one), then the
    evaluation: within the plain version's 1e-4 on [0, 100] of
    ``fuzzy_eval_pallas`` (XLA's and PyTorch's exp differ in the last
    bit) and of the plain version."""
    means, sigmas, centers = _mamdani()
    table, levels = build_rule_table()
    x = _fuzzy_inputs(p, normalize)
    want = np.asarray(fuzzy_eval_pallas(
        jnp.asarray(x), jnp.asarray(means), jnp.asarray(sigmas), table,
        levels, jnp.asarray(centers), interpret=True, normalize=normalize))
    t = [torch.tensor(a) for a in (x, means, sigmas, centers)]
    by_level = fe.rules_by_level(table, levels, torch.device("cpu"))
    got = fuzzy_eval_single_pass(t[0], t[1], t[2], by_level, t[3],
                                 normalize=normalize, split=8, ctas=ctas)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    plain = ref.fuzzy_eval_ref(t[0], t[1], t[2], torch.tensor(table),
                               torch.tensor(levels), t[3],
                               normalize=normalize)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-4)


def test_rule_packing_by_level_and_cached_per_table():
    """``rules_by_level``: ``packed_rules``' codes sorted stably by level,
    then each level's first rule and the count; packed once per table
    object, and two tables get two packings."""
    table, levels = build_rule_table()
    cpu = torch.device("cpu")
    codes = fe.packed_rules(table, levels, cpu)
    by_level = fe.rules_by_level(table, levels, cpu)
    n = table.shape[0]
    assert by_level.shape == (n + 10,)
    order = np.argsort(levels, kind="stable")
    np.testing.assert_array_equal(by_level[:n].numpy(),
                                  codes.numpy()[order])
    np.testing.assert_array_equal(
        by_level[n:].numpy(), np.searchsorted(np.sort(levels), np.arange(10)))
    assert fe.rules_by_level(table, levels, cpu) is by_level
    other_levels = np.where(levels > 0, levels - 1, 0)
    other = fe.rules_by_level(table, other_levels, cpu)
    assert not torch.equal(other, by_level)
    assert fe.rules_by_level(table, levels, cpu) is by_level
    with pytest.raises(ValueError):
        fe.packed_rules(table, np.full_like(levels, 9), cpu)
