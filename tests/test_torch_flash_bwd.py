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
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as ref_flash_attention
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
