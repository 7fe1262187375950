"""The port's hybrid-family serving path (jamba-v0.1-52b: mamba and
attention layers, MoE on every other one) against the JAX reference, on
the CPU.

Inputs are made from a numpy seed and handed to both packages; the
reference's parameters are drawn with ``jax.random`` and carried over
with ``convert.hybrid_params_from_jax``.  No reference model calls the
Pallas scan (``repro/models/mamba.py::_ssm_scan`` scans in jnp), so the
port's model (which goes through ``ops.selective_scan``, the kernel's
plain version on the CPU) is held against that default path, and the
plain version against ``selective_scan_pallas(..., interpret=True)``
directly, as ``tests/test_kernels.py`` runs it.  Everything runs at the
scaled-down width (d_model 256, Di 512, N 16, 4 q heads of 64, 4 experts
of 512, vocab 512): one group of 2 layers (attention + MLP, mamba +
MoE), two groups, and a GQA variant.

Known bf16 gaps that the tolerances cover: the reference's jnp
attention casts p to bf16 before p v where the port keeps it fp32; the
two libraries' bf16 products may sum in other orders; a bf16 router
near-tie may send a token to another expert (ROADMAP C3), so token
parity runs in fp32.  SiLU, softplus and the causal conv round as
XLA:CPU does, step by step, and are bit-equal.
"""
import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as ref_get_arch
from repro.configs import scaled_down as ref_scaled_down
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import mamba as ref_mamba
from repro.models import moe as ref_moe
from repro.models import registry as R
from repro.models import transformer as ref_tfm
from repro.serve import engine as ref_engine
from repro_torch.configs import get_arch, scaled_down
from repro_torch.convert import hybrid_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, mamba, moe, registry, transformer
from repro_torch.serve import engine
from torch_threads import torch_intra_op_threads  # noqa: F401

ARCH = "jamba-v0.1-52b"
CFG = scaled_down(get_arch(ARCH))
REF_CFG = ref_scaled_down(ref_get_arch(ARCH))
B, S = 2, 16
# bf16 tolerance of a layer or the model, relative to the largest
# magnitude: the two packages round bf16 at other places (see above), a
# few bf16 ulps (2^-8 relative each) through the layers
BF16_TOL = 2 ** -5
# the model's variants: one group, two groups, GQA
VARIANTS = {"one group": {}, "two groups": {"num_layers": 4},
            "gqa": {"num_kv_heads": 2}}


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 holds exactly, so both packages start from
    the same bf16 inputs."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _np(a) -> np.ndarray:
    return (a.float().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float32))


def _err(got, want) -> float:
    """Max abs error over the reference's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ulps(got: torch.Tensor, want) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    def key(t):                  # bf16 bits -> an integer line
        v = t.view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    w = torch.tensor(_np(want)).to(torch.bfloat16)
    return int((key(got) - key(w)).abs().max())


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(a).to(dtype)


def _dense_t(leaves):
    """A reference sub-tree's leaves as port tensors, 2-D dense weights
    transposed to ``(out, in)``."""
    return {k: torch.tensor(np.ascontiguousarray(np.asarray(v).T))
            if k in ("in_proj", "x_proj", "dt_proj", "out_proj", "router")
            else torch.tensor(np.asarray(v)) for k, v in leaves.items()}


@functools.lru_cache(maxsize=None)
def _model(variant: str):
    """(port cfg, reference cfg, reference params) of a variant, the
    parameters drawn once."""
    upd = VARIANTS[variant]
    cfg = dataclasses.replace(CFG, **upd)
    rcfg = dataclasses.replace(REF_CFG, **upd)
    rp = jax.device_get(jax.jit(R.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp


def _check_cache(cfg, got, want, rows=slice(None)):
    """The port's per-layer cache against the reference's (a tuple of
    ``period`` entries, each stacked over groups): attention slots' k, v
    in bf16 within BF16_TOL, pos and idx equal; mamba slots' conv (fp32
    of bf16 values) and h within BF16_TOL, in fp32.  ``rows`` picks the
    batch rows held."""
    period = cfg.attn_layer_period
    assert len(got["layers"]) == cfg.num_layers
    for i, c in enumerate(got["layers"]):
        w = jax.tree.map(lambda a: a[i // period],
                         want["layers"][i % period])
        assert sorted(c) == sorted(w), i
        if "k" in c:
            for key in ("k", "v"):
                assert c[key].dtype == torch.bfloat16, key
                assert _err(c[key][rows], np.asarray(w[key])[rows]) \
                    <= BF16_TOL, (i, key)
            np.testing.assert_array_equal(c["pos"].numpy(),
                                          np.asarray(w["pos"]))
            assert int(c["idx"]) == int(w["idx"])
        else:
            for key in ("conv", "h"):
                assert c[key].dtype == torch.float32, key
                assert w[key].dtype == jnp.float32, key
                assert _err(c[key][rows], np.asarray(w[key])[rows]) \
                    <= BF16_TOL, (i, key)


def _record_routes(monkeypatch):
    """From here on, record the router's probabilities (tokens, E) of
    every MoE call, in call order, in both packages: (port's list,
    reference's list)."""
    port, theirs = [], []
    port_moe, ref_apply = moe.apply_moe, ref_moe.apply_moe

    def port_hook(cfg, p, x):
        logits = F.linear(x.reshape(-1, x.shape[-1]), p["router"].to(x.dtype))
        port.append(torch.softmax(logits.float(), dim=-1).numpy())
        return port_moe(cfg, p, x)

    def ref_hook(cfg, p, x):
        logits = x.reshape(-1, x.shape[-1]) @ p["router"].astype(x.dtype)
        jax.debug.callback(lambda v: theirs.append(np.asarray(v)),
                           jax.nn.softmax(logits.astype(jnp.float32), -1),
                           ordered=True)
        return ref_apply(cfg, p, x)

    monkeypatch.setattr(moe, "apply_moe", port_hook)
    monkeypatch.setattr(ref_moe, "apply_moe", ref_hook)
    return port, theirs


def _rerouted_rows(cfg, port, theirs, rows: int) -> np.ndarray:
    """Batch rows (of ``rows``) with a token that the two packages sent
    to other experts in any recorded MoE call.  Each such choice must
    sit on a near-tie of the reference's router: its k-th and (k+1)-th
    probabilities within 2^-5 of each other's scale (the bf16 gap
    between the packages' inputs, ROADMAP C3)."""
    k = cfg.experts_per_token
    out = np.zeros(rows, bool)
    assert len(port) == len(theirs)
    for pp, rp in zip(port, theirs):
        top = lambda pr: np.sort(np.argsort(-pr, axis=-1, kind="stable")
                                 [:, :k], axis=-1)
        moved = (top(pp) != top(rp)).any(-1)
        srt = -np.sort(-rp, axis=-1)
        gap = (srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]
        assert (gap[moved] <= 2 ** -5).all(), gap[moved]
        out |= moved.reshape(rows, -1).any(-1)
    port.clear()
    theirs.clear()
    return out


def test_jamba_config_is_the_references():
    assert (dataclasses.asdict(get_arch(ARCH))
            == dataclasses.asdict(ref_get_arch(ARCH)))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)
    full = get_arch(ARCH)
    assert [full.layer_kind(i) for i in range(8)] == \
        [ref_get_arch(ARCH).layer_kind(i) for i in range(8)] == \
        ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [full.layer_is_moe(i) for i in range(8)] == [False, True] * 4
    # scaled down: period 2, attention first, MoE on the mamba layer
    assert [(CFG.layer_kind(i), CFG.layer_is_moe(i)) for i in range(2)] == \
        [("attn", False), ("mamba", True)]
    assert mamba.dt_rank(full) == 256 and mamba.dt_rank(CFG) == 16


# --------------------------------------------------------------------------
# (a) the scan's plain version
# --------------------------------------------------------------------------

def _scan_inputs(b, t, di, n, seed):
    """Model-like scan operands: unit-scale x, B and C, dt a softplus of
    small values, negative a, a nonzero initial state."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, di)) - 4.0)).astype(
        np.float32)
    bm, cm = (rng.normal(size=(b, t, n)).astype(np.float32)
              for _ in range(2))
    a = -np.exp(0.5 * rng.normal(size=(di, n))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(b, di, n))).astype(np.float32)
    return x, dt, bm, cm, a, h0


@pytest.mark.parametrize("b,t,di,n", [(1, 64, 256, 16), (2, 96, 512, 16),
                                      (2, 64, 512, 8)])
def test_selective_scan_plain_matches_pallas(b, t, di, n):
    """fp32 against ``selective_scan_pallas(interpret=True)``: y and hT
    within 1e-5 of their largest magnitude (sums in another order)."""
    x, dt, bm, cm, a, h0 = _scan_inputs(b, t, di, n, seed=t + di + n)
    wy, wh = selective_scan_pallas(*(jnp.asarray(v) for v in
                                     (x, dt, bm, cm, a, h0)),
                                   interpret=True)
    gy, gh = ref.selective_scan_ref(*(_t(v) for v in (x, dt, bm, cm, a, h0)))
    assert gy.dtype == gh.dtype == torch.float32
    assert _err(gy, wy) <= 1e-5 and _err(gh, wh) <= 1e-5


@pytest.mark.parametrize("bf16", [False, True])
def test_selective_scan_matches_the_model_scan(bf16):
    """Against the model's own scan, ``repro.models.mamba._ssm_scan``
    (dt and x cast to fp32 before their product in both; T = 512 runs
    its 256-step chunks): hT within 1e-5 of scale; y within 1e-5 in
    fp32, and in bf16 (both round the fp32 y once to x's dtype) within
    one bf16 step at the largest |y| (2^-8 of it)."""
    x, dt, bm, cm, a, h0 = _scan_inputs(2, 512, 256, 16, seed=3)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    if bf16:
        x, dt, bm, cm = (_bf16(v) for v in (x, dt, bm, cm))
    wy, wh = ref_mamba._ssm_scan(*(jnp.asarray(v, jdt) for v in
                                   (x, dt, bm, cm)),
                                 jnp.asarray(a), jnp.asarray(h0))
    gy, gh = ops.selective_scan(*(_t(v, tdt) for v in (x, dt, bm, cm)),
                                _t(a), _t(h0))
    assert gy.dtype == tdt and gh.dtype == torch.float32
    assert _err(gh, wh) <= 1e-5
    assert _err(gy, wy) <= (2 ** -8 if bf16 else 1e-5)
    assert torch.equal(gy, ref.selective_scan_ref(
        *(_t(v, tdt) for v in (x, dt, bm, cm)), _t(a), _t(h0))[0].to(tdt))


def test_selective_scan_op_on_cpu_is_the_plain_version():
    args = [_t(v) for v in _scan_inputs(2, 5, 40, 4, seed=9)]
    y, h = ops.selective_scan(*args)
    wy, wh = ref.selective_scan_ref(*args)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    y0, h0 = ops.selective_scan(*(a[:, :0] if i < 4 else a
                                  for i, a in enumerate(args)))
    assert y0.shape == (2, 0, 40) and torch.equal(h0, args[5])
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan_cuda(*args)


# --------------------------------------------------------------------------
# (b) the mamba mixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["conv prefill", "conv decode", "softplus",
                                "silu"])
def test_bf16_elementwise_steps_are_the_references(op):
    """The depthwise causal conv (taps summed in fp32, rounded once, then
    the bf16 bias) against XLA:CPU's bf16 ``conv_general_dilated`` and
    ``einsum``, and softplus against ``jax.nn.softplus``: bit-equal or
    within one bf16 step."""
    rng = np.random.default_rng(11)
    di, cw = 384, 4
    w = _bf16(rng.normal(size=(cw, di)).astype(np.float32) / 2)
    bias = _bf16(0.1 * rng.normal(size=di).astype(np.float32))
    jb = lambda v: jnp.asarray(v, jnp.bfloat16)
    if op in ("softplus", "silu"):
        x = _bf16(6 * rng.normal(size=(4, 4096)).astype(np.float32))
        want = getattr(jax.nn, op)(jb(x))
        got = (mamba.softplus if op == "softplus" else layers.silu)(
            _t(x, torch.bfloat16))
    elif op == "conv prefill":
        hist = _bf16(rng.normal(size=(2, 50 + cw - 1, di)).astype(
            np.float32))
        want = jax.lax.conv_general_dilated(
            jb(hist), jb(w)[:, None, :], (1,), "VALID",
            dimension_numbers=("NHC", "HIO", "NHC"),
            feature_group_count=di) + jb(bias)
        got = mamba.causal_conv(_t(hist, torch.bfloat16),
                                _t(w, torch.bfloat16)) + _t(bias,
                                                            torch.bfloat16)
    else:
        hist = _bf16(rng.normal(size=(3, cw, di)).astype(np.float32))
        want = (jnp.einsum("bwd,wd->bd", jb(hist), jb(w)) + jb(bias))[:,
                                                                     None]
        got = mamba.causal_conv(_t(hist, torch.bfloat16),
                                _t(w, torch.bfloat16)) + _t(bias,
                                                            torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, want) <= 1


@pytest.mark.parametrize("bf16", [False, True])
def test_mamba_apply_matches_reference_in_prefill_and_decode(bf16):
    """A prefill from no state, then a decode step from its state:
    outputs, conv and h within 1e-5 of scale in fp32 and 2^-7 in bf16
    (products summed in other orders)."""
    rcfg = REF_CFG
    rp = jax.device_get(ref_mamba.init_mamba_layer(jax.random.PRNGKey(3),
                                                   rcfg))
    p = _dense_t(rp)
    mine = mamba.init_mamba_layer(torch.Generator().manual_seed(0), CFG)
    assert {k: (v.shape, v.dtype) for k, v in mine.items()} == \
        {k: (v.shape, v.dtype) for k, v in p.items()}
    np.testing.assert_allclose(mine["A_log"].numpy(), _np(p["A_log"]),
                               rtol=1e-6)
    rng = np.random.default_rng(12)
    x = _bf16(rng.normal(size=(B, S, CFG.d_model)).astype(np.float32))
    x1 = _bf16(rng.normal(size=(B, 1, CFG.d_model)).astype(np.float32))
    tdt, jdt, tol = ((torch.bfloat16, jnp.bfloat16, 2 ** -7) if bf16
                     else (torch.float32, jnp.float32, 1e-5))
    jp = jax.tree.map(jnp.asarray, rp)
    want, wst = ref_mamba.mamba_apply(rcfg, jp, jnp.asarray(x, jdt), None)
    got, st = mamba.mamba_apply(CFG, p, _t(x, tdt), None)
    assert got.dtype == tdt
    assert st["conv"].dtype == st["h"].dtype == torch.float32
    assert st["conv"].shape == (B, CFG.ssm_conv_width - 1, 512)
    for g, w in ((got, want), (st["conv"], wst["conv"]), (st["h"], wst["h"])):
        assert _err(g, w) <= tol
    want1, wst1 = ref_mamba.mamba_apply(rcfg, jp, jnp.asarray(x1, jdt), wst)
    got1, st1 = mamba.mamba_apply(CFG, p, _t(x1, tdt), st)
    for g, w in ((got1, want1), (st1["conv"], wst1["conv"]),
                 (st1["h"], wst1["h"])):
        assert _err(g, w) <= tol


# --------------------------------------------------------------------------
# (c) MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tk,e", [(8, 4), (256, 4), (512, 16), (1000, 7)])
def test_positions_in_expert_bit_equal(tk, e):
    """Random and skewed assignments (one expert takes half of them, so
    ranks run far past any capacity): the same ranks, int32."""
    rng = np.random.default_rng(tk + e)
    flat = rng.integers(0, e, tk)
    flat[rng.random(tk) < 0.5] = e - 1
    want = ref_moe._positions_in_expert(jnp.asarray(flat, jnp.int32), e)
    got = moe._positions_in_expert(torch.tensor(flat), e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert moe.moe_capacity(CFG, tk) == ref_moe.moe_capacity(REF_CFG, tk)


@pytest.mark.parametrize("bf16", [False, True])
def test_apply_moe_dense_matches_reference(bf16):
    """Capacity at the mean load (capacity_factor 1), so assignments
    drop.  The load (which expert each assignment went to) equal; y
    within 1e-5 of scale in fp32 and 2^-7 in bf16 (products summed in
    other orders); lb_loss and z_loss within 1e-5 relative."""
    cfg = dataclasses.replace(CFG, capacity_factor=1.0)
    rcfg = dataclasses.replace(REF_CFG, capacity_factor=1.0)
    rp = jax.device_get(ref_moe.init_moe(jax.random.PRNGKey(4), rcfg,
                                         rcfg.d_model))
    p = _dense_t(rp)
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.d_model)
    assert {k: (v.shape, v.dtype) for k, v in mine.items()} == \
        {k: (v.shape, v.dtype) for k, v in p.items()}
    x = _bf16(np.random.default_rng(13).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32))
    tdt, jdt, tol = ((torch.bfloat16, jnp.bfloat16, 2 ** -7) if bf16
                     else (torch.float32, jnp.float32, 1e-5))
    want, waux = ref_moe._apply_moe_dense(rcfg, jax.tree.map(jnp.asarray, rp),
                                          jnp.asarray(x, jdt))
    got, aux = moe._apply_moe_dense(cfg, p, _t(x, tdt))
    assert got.dtype == tdt
    cap = moe.moe_capacity(cfg, 128)
    load = np.asarray(waux["expert_load"]) * 128 * 2
    assert load.max() > cap                      # some assignments drop
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  np.asarray(waux["expert_load"]))
    assert _err(got, want) <= tol
    for key in ("lb_loss", "z_loss"):
        assert aux[key].dtype == torch.float32
        np.testing.assert_allclose(float(aux[key]), float(waux[key]),
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# (d) the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(variant, monkeypatch):
    """Prefill and 3 decode steps in bf16: logits within 2^-5 of their
    largest magnitude, every cache entry in the reference's dtypes and
    as close, pos and idx equal.  A batch row whose token went to
    other experts in the two packages (allowed only on a near-tie of
    the router, see ``_rerouted_rows``) is held up to that step; the
    other row to the end."""
    cfg, rcfg, rp = _model(variant)
    port_routes, ref_routes = _record_routes(monkeypatch)
    ref_prefill = jax.jit(functools.partial(ref_tfm.prefill, rcfg),
                          static_argnames=("context",))
    ref_decode = jax.jit(R.decode_fn(rcfg, S + 4))
    params = hybrid_params_from_jax(rp)
    jp = jax.tree.map(jnp.asarray, rp)
    toks = _tokens(5, (B, S))
    want, want_cache = ref_prefill(jp, {"tokens": jnp.asarray(toks)},
                                   context=S + 4)
    got, cache = transformer.prefill(cfg, params,
                                     {"tokens": torch.tensor(toks)},
                                     context=S + 4)
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab_size)
    held = ~_rerouted_rows(cfg, port_routes, ref_routes, B)
    assert _err(got[held], np.asarray(want)[held]) <= BF16_TOL
    _check_cache(cfg, cache, want_cache, held)
    for i in range(3):
        nxt = _tokens(6 + i, (B, 1))
        want, want_cache = ref_decode(jp, want_cache, jnp.asarray(nxt))
        got, cache = registry.decode_fn(cfg, S + 4)(params, cache,
                                                    torch.tensor(nxt))
        held &= ~_rerouted_rows(cfg, port_routes, ref_routes, B)
        assert _err(got[held], np.asarray(want)[held]) <= BF16_TOL, i
        _check_cache(cfg, cache, want_cache, held)
    assert held.any()


def test_decode_from_a_fresh_cache_matches_reference():
    """``init_cache``: empty slot caches for attention layers, zero
    states for mamba layers; one decode step from it is the
    reference's."""
    cfg, rcfg, rp = _model("one group")
    want_cache = R.init_cache(rcfg, B, S + 4)
    cache = registry.init_cache(cfg, B, S + 4)
    _check_cache(cfg, cache, want_cache)
    nxt = _tokens(7, (B, 1))
    want, want_cache = R.decode_fn(rcfg, S + 4)(
        jax.tree.map(jnp.asarray, rp), want_cache, jnp.asarray(nxt))
    got, cache = registry.decode_fn(cfg, S + 4)(hybrid_params_from_jax(rp),
                                                cache, torch.tensor(nxt))
    assert _err(got, want) <= BF16_TOL
    _check_cache(cfg, cache, want_cache)


def test_greedy_generate_matches_reference_in_fp32(monkeypatch):
    """The same 8 greedy tokens when both packages compute in fp32 (the
    compute dtype monkeypatched in both, for this test only): the
    prefill, the decode loop, the mamba and slot caches' hand-off, the
    expert routing and the sampling are the reference's.  In bf16 a
    random model's top logits, and its router, tie within a rounding
    step."""
    monkeypatch.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    _, _, rp = _model("one group")
    toks = _tokens(10, (B, S))
    want, _ = ref_engine.generate(REF_CFG, jax.tree.map(jnp.asarray, rp),
                                  {"tokens": jnp.asarray(toks)}, 8)
    got, info = engine.generate(CFG, hybrid_params_from_jax(rp),
                                {"tokens": torch.tensor(toks)}, 8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    attn_c, mamba_c = info["cache"]["layers"]
    assert attn_c["k"].dtype == torch.float32 and attn_c["k"].shape[1] == S + 8
    assert int(attn_c["idx"]) == S + 8
    assert mamba_c["h"].shape == (B, 512, 16)


def test_prefill_decode_consistency():
    """The port alone, as ``tests/test_arch_smoke.py::
    test_prefill_decode_consistency`` holds the reference: a decode step
    after prefill(prompt) gives prefill(prompt + token)'s last logits.
    Capacity is raised so that no token drops (dropping makes the full
    path diverge from the per-token decode path by design)."""
    cfg = dataclasses.replace(CFG, capacity_factor=8.0)
    params = registry.init_serving_params(torch.Generator().manual_seed(3),
                                          cfg)
    toks = torch.tensor(_tokens(14, (1, 32)))
    logits1, cache = registry.prefill_fn(cfg)(params, {"tokens": toks},
                                              context=64)
    tok = torch.argmax(logits1, -1)
    logits2, _ = registry.decode_fn(cfg, 64)(params, cache, tok)
    full, _ = registry.prefill_fn(cfg)(
        params, {"tokens": torch.cat([toks, tok], dim=1)})
    a, b = logits2[:, -1], full[:, -1]
    assert float((a - b).abs().max() / (b.std() + 1e-6)) < 0.1
    assert torch.equal(a.argmax(-1), b.argmax(-1))


# --------------------------------------------------------------------------
# (e) init, and the CLI
# --------------------------------------------------------------------------

def test_port_init_and_serving_params():
    """The port's own initialisation gives the converted reference
    tree's structure, shapes and dtypes; ``init_serving_params``, which
    casts each layer before drawing the next, is bit-equal to
    ``serving_params(init_params(...))`` from the same generator state;
    the bf16 cast keeps the logits and caches bit-equal."""
    _, _, rp = _model("two groups")
    cfg = dataclasses.replace(CFG, num_layers=4)
    mine = registry.init_params(torch.Generator().manual_seed(0), cfg)
    theirs = hybrid_params_from_jax(rp)
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    fm, ft = flat(mine), flat(theirs)
    assert fm.keys() == ft.keys()
    for key in fm:
        assert fm[key].shape == ft[key].shape and \
            fm[key].dtype == ft[key].dtype, key
    assert sorted(mine["blocks"][3]) == ["mamba", "moe", "n1", "n2"]
    assert sorted(mine["blocks"][2]) == ["attn", "mlp", "n1", "n2"]

    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = registry.serving_params(registry.init_params(g1, cfg))
    b = registry.init_serving_params(g2, cfg)
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    assert all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
               for k in fa)
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))
    for key, dt in (("in_proj", torch.bfloat16), ("conv_w", torch.bfloat16),
                    ("A_log", torch.float32), ("D", torch.bfloat16)):
        assert b["blocks"][1]["mamba"][key].dtype == dt, key
    assert b["blocks"][1]["moe"]["wi"].dtype == torch.bfloat16
    assert b["blocks"][1]["n1"]["w"].dtype == torch.float32

    toks = {"tokens": torch.tensor(_tokens(11, (B, S)))}
    p16 = registry.serving_params(hybrid_params_from_jax(rp))
    la, ca = registry.prefill_fn(cfg)(theirs, toks, context=S + 1)
    lb, cb = registry.prefill_fn(cfg)(p16, toks, context=S + 1)
    assert torch.equal(la, lb)
    nxt = toks["tokens"][:, :1]
    la, ca = registry.decode_fn(cfg, S + 1)(theirs, ca, nxt)
    lb, cb = registry.decode_fn(cfg, S + 1)(p16, cb, nxt)
    assert torch.equal(la, lb)
    for x, y in zip(ca["layers"], cb["layers"]):
        assert all(torch.equal(x[k_], y[k_]) for k_ in x)


def test_serve_cli_runs_jamba_reduced_on_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--max-new", "4"]) == 0
    lines = out.getvalue().strip().splitlines()
    stats = json.loads(lines[-1])
    assert stats["arch"] == ARCH and stats["device"] == "cpu"
    assert stats["layers"] == 2 and stats["d_model"] == 256
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    first = json.loads(lines[1].split(":", 1)[1])
    assert len(first) == 4 and all(0 <= t < CFG.vocab_size for t in first)
