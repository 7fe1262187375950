"""The rest of the LM zoo's serving path against the JAX reference, on
the CPU: the configs of all ten arch ids, the moe family (qwen3-moe
with qk_norm, phi3.5-moe), the vlm family (paligemma: patch embeddings
before the tokens, prefix-LM masking) and the dense configs that gemma
does not cover (yi-6b: an untied head and rope_theta 5e6; granite-8b;
minicpm-2b: residual_scale).  Whisper (the audio family) is in
``tests/test_torch_audio.py``.

Inputs are made from a numpy seed and handed to both packages; the
reference's parameters are drawn with ``jax.random`` at the
scaled-down width (2 layers, d_model 256, 4 q heads, 4 experts top-2,
vocab 512, 16 prefix positions) and carried over with
``convert.dense_params_from_jax``, which takes the moe and vlm trees
too.  The reference's model attends through its jnp chunked version;
the port's through ``ops.flash_attention``'s plain version on the CPU.

bf16 gaps that the tolerance (2^-5 of the largest magnitude) covers are
those of ``tests/test_torch_dense.py``; a bf16 router near-tie may send
a token to other experts (ROADMAP C3), so a batch row is held only until
such a reroute, and token parity runs in fp32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.configs import scaled_down as ref_scaled_down
from repro.models import registry as R
from repro.models import transformer as ref_tfm
from repro.serve import engine as ref_engine
from repro_torch.configs import ARCH_IDS, get_arch, scaled_down
from repro_torch.convert import dense_params_from_jax
from repro_torch.models import registry, transformer
from repro_torch.serve import engine
from test_torch_hybrid import _record_routes, _rerouted_rows
from torch_threads import torch_intra_op_threads  # noqa: F401

B, S = 2, 16
BF16_TOL = 2 ** -5
MOE = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
DENSE = ("yi-6b", "granite-8b", "minicpm-2b")
VLM = "paligemma-3b"


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 holds exactly."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _np(a) -> np.ndarray:
    return (a.float().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float32))


def _err(got, want) -> float:
    """Max abs error over the reference's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(port cfg, reference cfg, reference params) of ``arch`` scaled
    down, the parameters drawn once."""
    rcfg = ref_scaled_down(ref_get_arch(arch))
    rp = jax.device_get(jax.jit(R.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))
    return scaled_down(get_arch(arch)), rcfg, rp


def _batch(cfg, seed, tokens=S):
    """(port batch, reference batch): ``tokens`` random tokens, and for
    the vlm family bf16-exact patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, tokens)).astype(np.int32)
    mine = {"tokens": torch.tensor(toks)}
    theirs = {"tokens": jnp.asarray(toks)}
    if cfg.family == "vlm":
        pre = _bf16(rng.normal(size=(B, cfg.num_prefix_tokens,
                                     cfg.d_model)).astype(np.float32))
        mine["prefix"] = torch.tensor(pre).to(torch.bfloat16)
        theirs["prefix"] = jnp.asarray(pre, jnp.bfloat16)
    return mine, theirs


def _check_cache(got, want, rows=slice(None)):
    """The port's per-layer slot caches against the reference's stacked
    one: k, v in bf16 within BF16_TOL (of ``rows``), pos and idx
    equal."""
    w = want["layers"]
    assert len(got["layers"]) == w["k"].shape[0]
    for i, c in enumerate(got["layers"]):
        for key in ("k", "v"):
            assert c[key].dtype == torch.bfloat16, key
            assert w[key].dtype == jnp.bfloat16, key
            assert _err(c[key][rows], np.asarray(w[key][i])[rows]) \
                <= BF16_TOL, (i, key)
        np.testing.assert_array_equal(c["pos"].numpy(),
                                      np.asarray(w["pos"][i]))
        assert int(c["idx"]) == int(w["idx"][i])


# --------------------------------------------------------------------------
# (a) the configs
# --------------------------------------------------------------------------

def test_arch_ids_are_the_references_in_order():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_is_the_references(arch):
    """Field for field, ``citation`` included, at full size and scaled
    down."""
    assert (dataclasses.asdict(get_arch(arch))
            == dataclasses.asdict(ref_get_arch(arch)))
    assert (dataclasses.asdict(scaled_down(get_arch(arch)))
            == dataclasses.asdict(ref_scaled_down(ref_get_arch(arch))))


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llama-7b")


# --------------------------------------------------------------------------
# (b) prefill and decode: moe, vlm, the dense configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE + (VLM,) + DENSE)
def test_prefill_and_decode_match_reference(arch, monkeypatch):
    """Prefill and 3 decode steps in bf16: logits within 2^-5 of their
    largest magnitude, every slot cache in the reference's dtypes and as
    close, pos and idx equal.  With MoE layers a batch row whose token
    went to other experts in the two packages (only on a near-tie of the
    router) is held up to that step; the other row to the end."""
    cfg, rcfg, rp = _model(arch)
    routes = _record_routes(monkeypatch)
    prompt = S + cfg.num_prefix_tokens
    ctx = prompt + 4
    ref_prefill = jax.jit(functools.partial(ref_tfm.prefill, rcfg),
                          static_argnames=("context",))
    ref_decode = jax.jit(R.decode_fn(rcfg, ctx))
    params = dense_params_from_jax(rp)
    jp = jax.tree.map(jnp.asarray, rp)
    mine, theirs = _batch(cfg, 5)
    want, want_cache = ref_prefill(jp, theirs, context=ctx)
    got, cache = transformer.prefill(cfg, params, mine, context=ctx)
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab_size)
    held = np.ones(B, bool)
    if cfg.is_moe:
        held &= ~_rerouted_rows(cfg, *routes, B)
    assert _err(got[held], np.asarray(want)[held]) <= BF16_TOL
    _check_cache(cache, want_cache, held)
    assert cache["layers"][0]["k"].shape[1] == ctx
    assert int(cache["layers"][0]["idx"]) == prompt
    for i in range(3):
        nxt = np.random.default_rng(6 + i).integers(
            0, cfg.vocab_size, (B, 1)).astype(np.int32)
        want, want_cache = ref_decode(jp, want_cache, jnp.asarray(nxt))
        got, cache = registry.decode_fn(cfg, ctx)(params, cache,
                                                  torch.tensor(nxt))
        if cfg.is_moe:
            held &= ~_rerouted_rows(cfg, *routes, B)
        assert _err(got[held], np.asarray(want)[held]) <= BF16_TOL, i
        _check_cache(cache, want_cache, held)
    assert held.any()


def test_vlm_prefix_attends_bidirectionally():
    """The port alone: a patch embedding late in the prefix moves the
    logits of the first prefix position (prefix-LM), a token after the
    prefix does not (causal)."""
    cfg, _, rp = _model(VLM)
    params = dense_params_from_jax(rp)
    mine, _ = _batch(cfg, 7)
    x0, _ = transformer.forward(cfg, params, mine, mode="prefill")
    late = dict(mine, prefix=mine["prefix"].clone())
    late["prefix"][:, -1] += 1.0
    x1, _ = transformer.forward(cfg, params, late, mode="prefill")
    assert not torch.equal(x0[:, 0], x1[:, 0])
    tok = dict(mine, tokens=mine["tokens"].clone())
    tok["tokens"][:, -1] = (tok["tokens"][:, -1] + 1) % cfg.vocab_size
    x2, _ = transformer.forward(cfg, params, tok, mode="prefill")
    assert torch.equal(x0[:, :-1], x2[:, :-1])


# --------------------------------------------------------------------------
# (c) greedy tokens in fp32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MOE[0], VLM])
def test_greedy_generate_matches_reference_in_fp32(arch, monkeypatch):
    """The same 8 greedy tokens when both packages compute in fp32 (the
    compute dtype monkeypatched in both, for this test only): the
    prefill (with paligemma's prefix), the decode loop, the cache sized
    for the prefix too, qwen3's routing and qk_norm, the sampling."""
    monkeypatch.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    cfg, rcfg, rp = _model(arch)
    mine, theirs = _batch(cfg, 10)
    want, want_info = ref_engine.generate(
        rcfg, jax.tree.map(jnp.asarray, rp), theirs, 8)
    got, info = engine.generate(cfg, dense_params_from_jax(rp), mine, 8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info["prompt_len"] == want_info["prompt_len"] == (
        S + cfg.num_prefix_tokens)
    c = info["cache"]["layers"][0]
    assert c["k"].dtype == torch.float32
    assert c["k"].shape[1] == info["prompt_len"] + 8
    assert int(c["idx"]) == info["prompt_len"] + 8


# --------------------------------------------------------------------------
# (d) init and serving params
# --------------------------------------------------------------------------

def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", [MOE[0], VLM])
def test_port_init_and_serving_params(arch):
    """The port's own initialisation gives the converted reference
    tree's structure, shapes and dtypes (every layer an MoE for qwen3,
    with its qk norms); ``init_serving_params`` is bit-equal to
    ``serving_params(init_params(...))`` from the same generator state,
    with the router and expert stacks in bf16; the bf16 cast keeps the
    logits and caches bit-equal."""
    cfg, _, rp = _model(arch)
    theirs = dense_params_from_jax(rp)
    fm = _flat(registry.init_params(torch.Generator().manual_seed(0), cfg))
    ft = _flat(theirs)
    assert fm.keys() == ft.keys()
    for key in fm:
        assert fm[key].shape == ft[key].shape and \
            fm[key].dtype == ft[key].dtype, key
    want_groups = (["attn", "moe", "n1", "n2"] if cfg.is_moe
                   else ["attn", "mlp", "n1", "n2"])
    assert all(sorted(lp) == want_groups for lp in theirs["blocks"])

    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    fa = _flat(registry.serving_params(registry.init_params(g1, cfg)))
    fb = _flat(registry.init_serving_params(g2, cfg))
    assert fa.keys() == fb.keys()
    assert all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
               for k in fa)
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))
    for key, t in fb.items():
        want = (torch.float32 if "'n" in key or "final_norm" in key
                or key.endswith(("['qn']", "['kn']")) else torch.bfloat16)
        assert t.dtype == want, key

    mine, _ = _batch(cfg, 11)
    p16 = registry.serving_params(dense_params_from_jax(rp))
    ctx = S + cfg.num_prefix_tokens + 1
    la, ca = registry.prefill_fn(cfg)(theirs, mine, context=ctx)
    lb, cb = registry.prefill_fn(cfg)(p16, mine, context=ctx)
    assert torch.equal(la, lb)
    nxt = mine["tokens"][:, :1]
    la, ca = registry.decode_fn(cfg, ctx)(theirs, ca, nxt)
    lb, cb = registry.decode_fn(cfg, ctx)(p16, cb, nxt)
    assert torch.equal(la, lb)
    for x, y in zip(ca["layers"], cb["layers"]):
        assert all(torch.equal(x[k_], y[k_]) for k_ in x)


# --------------------------------------------------------------------------
# (e) the reference's MoE dispatch couples the batch's rows through drops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor,coupled", [(0.5, True),
                                                     (8.0, False)])
def test_moe_drops_couple_the_batch_rows(capacity_factor, coupled):
    """A property of the reference's dense dispatch, which the port
    keeps: an assignment's position in its expert counts the batch's
    earlier tokens (token-major), so when the capacity drops some, other
    tokens of row 0 change which of row 1's assignments are kept, and
    row 1's output moves.  With a capacity that drops nothing the rows
    are independent.  So a check that holds a batch row until one of
    its own tokens is rerouted (ROADMAP C3) needs a capacity that drops
    nothing (``chip_smoke.py``'s qwen3-moe check)."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe
    cfg, rcfg, rp = _model(MOE[0])
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    rcfg = dataclasses.replace(rcfg, capacity_factor=capacity_factor)
    lp = dense_params_from_jax(rp)["blocks"][0]["moe"]
    lp_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), rp["blocks"]["moe"])
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[0] = rng.normal(size=x2[0].shape)
    ref_apply = jax.jit(functools.partial(ref_moe._apply_moe_dense, rcfg))
    port = [moe.apply_moe(cfg, lp, torch.tensor(a))[0][1] for a in (x, x2)]
    theirs = [np.asarray(ref_apply(lp_ref, jnp.asarray(a))[0][1])
              for a in (x, x2)]
    assert (not torch.equal(*port)) == coupled
    assert (not np.array_equal(*theirs)) == coupled
    assert _err(port[0], theirs[0]) <= 1e-5
