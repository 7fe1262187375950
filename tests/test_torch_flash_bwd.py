"""Flash attention's backward on the CPU: the plain versions beside the
hand-written kernels (``kernels/ref.py::flash_attention_lse_ref`` and
``flash_attention_bwd_ref``) and the autograd Function of
``kernels/ops.py`` against ``torch.autograd`` through the plain
forward and against ``jax.vjp`` of the reference's attention
(``repro/models/attention.py::flash_attention``, its jnp chunked
version, which the reference trains through).

Masks: causal, sliding window, prefix-LM and none; GQA groups of 1, 4
and 8; sequence lengths that are no multiple of the kernels' tiles (64
and 32 rows).  All in fp32: within 1e-5 of each gradient's largest
magnitude (sums in other orders; the explicit formulas against
autodiff's).  The kernels themselves are held against these versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The bf16 kernels' split of the dK/dV work (``bwd_plan`` in
``kernels/flash_attention.py``): its block counts at the training
shapes, and the decomposition the kernels rely on, each block's fp32
partial of dK and dV (a kv tile, a run of q tiles, a share of the
group's q heads) added in the plan's order, against the explicit
formulas within 1e-6 of scale.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as ref_flash_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from torch_threads import torch_intra_op_threads  # noqa: F401

TOL = 1e-5
# (Sq, Skv, causal, window, prefix_len)
MASKS = {
    "causal": (100, 100, True, 0, 0),
    "window": (100, 100, True, 24, 0),
    "prefix": (100, 100, True, 0, 40),
    "none": (70, 100, False, 0, 0),
}
GROUPS = {1: (4, 4), 4: (8, 2), 8: (8, 1)}      # group -> (Hq, Hkv)
B, DH = 2, 32


def _inputs(case, group, seed=0):
    sq, skv = case[:2]
    hq, hkv = GROUPS[group]
    rng = np.random.default_rng(seed)
    shapes = ((B, sq, hq, DH), (B, skv, hkv, DH), (B, skv, hkv, DH),
              (B, sq, hq, DH))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _kw(case):
    return dict(causal=case[2], window=case[3], prefix_len=case[4])


def _err(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _ref_vjp(sq, skv, causal, window, prefix_len):
    def fwd(q, k, v):
        return ref_flash_attention(q, k, v, jnp.arange(sq), jnp.arange(skv),
                                   causal=causal, window=window,
                                   prefix_len=prefix_len)

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(fwd, q, k, v)
        return (out,) + vjp(do)
    return run


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_bwd_ref_matches_autograd_and_the_reference(mask, group):
    """dq, dk, dv of the explicit formulas against torch.autograd
    through ``flash_attention_ref`` and against ``jax.vjp`` of the
    reference's attention; the forward against the reference's too."""
    case = MASKS[mask]
    q, k, v, do = _inputs(case, group)
    kw = _kw(case)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out, lse = ref.flash_attention_lse_ref(*leaves, **kw)
    out.backward(torch.tensor(do))
    got = ref.flash_attention_bwd_ref(*(t.detach() for t in leaves),
                                      out.detach(), lse, torch.tensor(do),
                                      **kw)
    want_out, *want = _ref_vjp(*case)(*(jnp.asarray(a) for a in
                                        (q, k, v, do)))
    assert _err(out, want_out) <= TOL
    for name, g, t, w in zip(("dq", "dk", "dv"), got, leaves, want):
        assert g.dtype == torch.float32 and g.shape == t.shape, name
        assert _err(g, t.grad) <= TOL, name
        assert _err(g, w) <= TOL, name


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_lse_ref_is_the_masked_logsumexp(mask):
    """lse (B, Hq, Sq) against a float64 log-sum-exp of the explicitly
    masked scores, within 1e-5 of its largest magnitude; the output is
    ``flash_attention_ref``'s bit for bit."""
    case = MASKS[mask]
    q, k, v, _ = _inputs(case, 4, seed=1)
    kw = _kw(case)
    out, lse = ref.flash_attention_lse_ref(*map(torch.tensor, (q, k, v)),
                                           **kw)
    assert torch.equal(out, ref.flash_attention_ref(
        *map(torch.tensor, (q, k, v)), **kw))
    sq, skv = case[:2]
    hq, hkv = GROUPS[4]
    kk = np.repeat(k.astype(np.float64), hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(DH)
    qp, kp = np.arange(sq)[:, None], np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if case[2]:
        ok = kp <= qp
        if case[3]:
            ok &= (qp - kp) < case[3]
        if case[4]:
            ok |= kp < case[4]
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (B, hq, sq) and lse.dtype == torch.float32
    assert _err(lse, want) <= TOL


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_autograd_function_passes_gradcheck_in_fp64(mask):
    """The Function around ``flash_attention`` (forward with lse, the
    plain backward on the CPU) against finite differences, fp64, tiny
    sizes, a GQA group of 2."""
    sq, skv, causal, window, prefix = MASKS[mask]
    sq, skv = min(sq, 7) if causal else 5, 7
    kw = dict(causal=causal, window=min(window, 3), prefix_len=min(prefix, 2))
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(1, s, h, 4, generator=g, dtype=torch.float64,
                        requires_grad=True)
            for s, h in ((sq, 2), (skv, 1), (skv, 1))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, **kw), args)


def test_no_grad_call_is_the_forward_alone():
    """Under ``no_grad`` (serving) ``ops.flash_attention`` is the plain
    forward, bit for bit, and keeps no graph."""
    q, k, v, _ = _inputs(MASKS["causal"], 8)
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    with torch.no_grad():
        out = ops.flash_attention(*t)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention_ref(*map(torch.tensor,
                                                         (q, k, v))))


# (B, Sq, Skv, Hq, Hkv, Dh): the training shapes of chip_smoke.py
# (gemma-2b at B=2 and its microbatch of 1, minicpm-2b), a group of 3 and
# a group past BWD_HEAD_SPLITS
PLAN_SHAPES = {
    "gemma-2b": (2, 1024, 1024, 8, 1, 256),
    "gemma-2b-microbatch": (1, 1024, 1024, 8, 1, 256),
    "minicpm-2b": (2, 1024, 1024, 36, 36, 64),
    "group-of-3": (2, 1024, 1024, 12, 4, 128),
    "group-of-16": (2, 512, 512, 16, 1, 64),
}


def test_bwd_plan_fills_the_card_at_gemma_microbatch():
    """gemma-2b's microbatch (B=1, one kv head) gives the dK/dV kernel at
    least 128 blocks (16 unsplit) and its partials a scratch; at B=2 it
    has 256 blocks, as has the dQ kernel (a block a tile of 64 (position,
    head) rows)."""
    shape = PLAN_SHAPES["gemma-2b-microbatch"]
    dq_blocks, kv_blocks, scratch = fa.bwd_sizes(fa.bwd_plan(*shape), *shape)
    assert kv_blocks >= 128 and dq_blocks == 128 and scratch > 0
    assert fa.bwd_sizes(fa.bwd_plan(*PLAN_SHAPES["gemma-2b"]),
                        *PLAN_SHAPES["gemma-2b"])[:2] == (256, 256)


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_bwd_plan_splits_divide_the_group_and_runs_cover_the_tiles(name):
    """The head splits divide the group (at most BWD_HEAD_SPLITS); every
    kv tile's q-tile runs cut [0, nqt) into ranges in order, as many a
    tile as kv tile 0's, none of tile 0's empty; no split (minicpm-2b:
    one kv head a q head) needs no scratch."""
    b, sq, skv, hq, hkv, dh = PLAN_SHAPES[name]
    plan = fa.bwd_plan(b, sq, skv, hq, hkv, dh)
    splits, q_run = plan
    assert (hq // hkv) % splits == 0 and splits <= fa.BWD_HEAD_SPLITS
    assert q_run >= 1
    runs = fa.bwd_runs(plan, sq, skv)
    nqt = -(-sq // fa.BWD_TILE)
    assert len(runs) == -(-skv // fa.BWD_TILE)
    assert len({len(c) for c in runs}) == 1
    for cuts in runs:
        assert cuts[0] == 0 and cuts[-1] == nqt
        assert all(a <= c for a, c in zip(cuts, cuts[1:]))
    assert all(a < c for a, c in zip(runs[0], runs[0][1:]))
    if name == "minicpm-2b":
        assert plan == (1, nqt)
        assert fa.bwd_sizes(plan, *PLAN_SHAPES[name])[2] == 0


def test_bwd_plan_depends_on_shapes_alone():
    """The plan is a function of the six shape integers: recomputed from
    scratch it is the same, and it has no other input (no mask, no
    values), so every sum's order, and so the kernels' bits, are fixed
    by the shapes."""
    import inspect
    assert list(inspect.signature(fa.bwd_plan).parameters) == [
        "b", "sq", "skv", "hq", "hkv", "dh"]
    first = {n: fa.bwd_plan(*s) for n, s in PLAN_SHAPES.items()}
    fa.bwd_plan.cache_clear()
    assert {n: fa.bwd_plan(*s) for n, s in PLAN_SHAPES.items()} == first
    assert all(isinstance(x, int) for p in first.values() for x in p)


# (B, Sq, Skv, Hq, Hkv, Dh, causal, window, prefix_len): shapes whose
# plan splits the dK/dV work (heads and q runs), small enough for the CPU
SPLIT_CASES = {
    "mqa-causal": (1, 300, 300, 8, 1, 64, True, 0, 0),
    "group-of-3-window": (2, 200, 200, 12, 4, 64, True, 40, 0),
    "group-of-16-prefix": (1, 130, 100, 16, 1, 64, True, 0, 70),
    "mqa-unmasked": (1, 96, 160, 8, 1, 64, False, 0, 0),
}


def _split_partials(case, seed=3):
    """The explicit formulas' dk, dv (fp32) and the same gradients as the
    kernels add them: each dK/dV block's fp32 partial, added in the
    plan's slot order (runs, then head shares), then scaled (dk)."""
    b, sq, skv, hq, hkv, dh, causal, window, prefix = case
    g = hq // hkv
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.normal(size=sh).astype(np.float32))
                   for sh in ((b, sq, hq, dh), (b, skv, hkv, dh),
                              (b, skv, hkv, dh), (b, sq, hq, dh)))
    o, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)[1:]
    # P and dS as the plain version forms them: (B, Hkv, G, Sq, Skv)
    s = ref._attention_scores(q, k, **kw)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None])
    dof = do.reshape(b, sq, hkv, g, dh)
    qf = q.reshape(b, sq, hkv, g, dh)
    dlt = (dof * o.reshape(b, sq, hkv, g, dh)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dof, v) - dlt[..., None])

    plan = fa.bwd_plan(b, sq, skv, hq, hkv, dh)
    splits, t = plan[0], fa.BWD_TILE
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j, cuts in enumerate(fa.bwd_runs(plan, sq, skv)):
        ks = slice(j * t, (j + 1) * t)
        acc_k = torch.zeros_like(k[:, ks])
        acc_v = torch.zeros_like(v[:, ks])
        for r in range(len(cuts) - 1):
            qs = slice(cuts[r] * t, cuts[r + 1] * t)
            for sh in range(splits):
                gs = slice(sh * g // splits, (sh + 1) * g // splits)
                acc_k += torch.einsum("bhgqk,bqhgd->bkhd",
                                      ds[:, :, gs, qs, ks], qf[:, qs, :, gs])
                acc_v += torch.einsum("bhgqk,bqhgd->bkhd",
                                      p[:, :, gs, qs, ks], dof[:, qs, :, gs])
        dk[:, ks], dv[:, ks] = acc_k / math.sqrt(dh), acc_v
    return plan, (dk, dv), want


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_partials_added_in_the_plan_order_give_the_gradients(name):
    """Each dK/dV block's fp32 partial (a kv tile, a q-tile run, a share
    of the group's q heads), added in the plan's order and scaled once,
    equals the explicit formulas' dk and dv within 1e-6 of each one's
    largest magnitude: the split is exact but for fp32's order of
    summation."""
    plan, got, want = _split_partials(SPLIT_CASES[name])
    runs = fa.bwd_runs(plan, *SPLIT_CASES[name][1:3])
    assert plan[0] > 1 and len(runs[0]) > 2          # heads and q runs
    for gname, x, w in zip(("dk", "dv"), got, want):
        assert _err(x, w.detach().numpy()) <= 1e-6, gname
