"""The port's dense-family serving path (gemma-2b) against the JAX
reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages; the
reference's parameters are drawn with ``jax.random`` and carried over
with ``convert.dense_params_from_jax``.  The reference's model attends
through its own jnp chunked ``flash_attention``, so the port's model
(which goes through ``ops.flash_attention``, the kernel's plain version
on the CPU) is held against that default path, and the plain version
against ``flash_attention_pallas(..., interpret=True)`` directly, as
``tests/test_kernels.py`` runs it.  Everything runs at the scaled-down
width (2 layers, d_model 256, 4 q heads over 1 kv head, head_dim 64,
vocab 512) or, once, with head_dim 256.

Known bf16 gaps that the tolerances cover: XLA:CPU computes the
tanh-GELU in bf16 step by step where torch upcasts (an ulp on ~40% of
the outputs); the reference's jnp attention casts p to bf16 before p v
where the kernel and the port keep it fp32.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import scaled_down as ref_scaled_down
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as ref_layers
from repro.models import registry as R
from repro.models import transformer as ref_tfm
from repro.serve import engine as ref_engine
from repro_torch.configs import get_arch, scaled_down
from repro_torch.convert import dense_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, registry, transformer
from repro_torch.serve import engine
from torch_threads import torch_intra_op_threads  # noqa: F401

CFG = scaled_down(get_arch("gemma-2b"))
REF_CFG = ref_scaled_down(ref_get_arch("gemma-2b"))
B, S = 2, 16
# bf16 tolerance of a layer or the model, relative to the largest
# magnitude: the two packages round bf16 at other places (see above), a
# few bf16 ulps (2^-8 relative each) through the layers
BF16_TOL = 2 ** -5


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 holds exactly, so both packages start from
    the same bf16 inputs."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _err(got, want) -> float:
    """Max abs error over the reference's largest magnitude."""
    got = (got.float().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def _pair(head_dim=None, **kw):
    """(port cfg, reference cfg), scaled down, with the same changes."""
    upd = dict(kw, **({"head_dim": head_dim} if head_dim else {}))
    return (dataclasses.replace(CFG, **upd),
            dataclasses.replace(REF_CFG, **upd))


_REF_PARAMS = {}


def _ref_params(rcfg):
    key = (rcfg.head_dim, rcfg.sliding_window)
    if key not in _REF_PARAMS:
        _REF_PARAMS[key] = jax.device_get(
            R.init_params(jax.random.PRNGKey(0), rcfg))
    return _REF_PARAMS[key]


def _check_cache(got, want):
    """The port's per-layer slot caches against the reference's stacked
    one: k, v in the reference's dtype (bf16) within BF16_TOL, pos and
    idx equal."""
    w = want["layers"]
    for i, c in enumerate(got["layers"]):
        for key in ("k", "v"):
            assert c[key].dtype == torch.bfloat16, key
            assert w[key].dtype == jnp.bfloat16, key
            assert _err(c[key], w[key][i]) <= BF16_TOL, (i, key)
        np.testing.assert_array_equal(c["pos"].numpy(),
                                      np.asarray(w["pos"][i]))
        assert c["pos"].dtype == c["idx"].dtype == torch.int32
        assert int(c["idx"]) == int(w["idx"][i])


def test_gemma_config_is_the_references():
    assert (dataclasses.asdict(get_arch("gemma-2b"))
            == dataclasses.asdict(ref_get_arch("gemma-2b")))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)
    # 256 > 2048 // 8 is false: scaled-down gemma is not "oversized"
    assert (CFG.num_heads, CFG.num_kv_heads, CFG.head_dim,
            CFG.sliding_window) == (4, 1, 64, 64)


# --------------------------------------------------------------------------
# (a) the kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,hq,hkv,dh,causal,window,prefix", [
    (128, 128, 4, 2, 32, True, 0, 0),       # GQA causal
    (256, 256, 4, 1, 64, True, 64, 0),      # MQA sliding window
    (128, 128, 2, 2, 32, True, 0, 32),      # prefix-LM
    (96, 160, 4, 4, 32, False, 0, 0),       # cross-attn, irregular sizes
    (64, 64, 8, 1, 256, True, 0, 0),        # gemma's heads: MQA, Dh 256
])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_plain_matches_pallas(sq, skv, hq, hkv, dh, causal,
                                              window, prefix, bf16):
    """fp32: 2e-5 of the largest |out| (sums in another order).  bf16
    inputs, fp32 compute, one rounding of the output: 2^-7 of it (one
    bf16 ulp at the largest value, either side rounding)."""
    rng = np.random.default_rng(sq + skv + dh + bf16)
    q, k, v = (rng.normal(size=(2, s, h, dh)).astype(np.float32)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    want = flash_attention_pallas(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
        window=window, prefix_len=prefix, interpret=True)
    got = ref.flash_attention_ref(*(torch.tensor(a).to(tdt)
                                    for a in (q, k, v)),
                                  causal=causal, window=window,
                                  prefix_len=prefix)
    assert got.dtype == tdt and want.dtype == jdt
    assert _err(got, want) <= (2 ** -7 if bf16 else 2e-5)


def test_flash_attention_op_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.normal(size=(2, 40, 4, 64)).astype(np.float32))
    k, v = (torch.tensor(rng.normal(size=(2, 40, 1, 64)).astype(np.float32))
            for _ in range(2))
    for kw in (dict(causal=True), dict(causal=True, window=8),
               dict(causal=True, prefix_len=5), dict(causal=False)):
        assert torch.equal(ops.flash_attention(q, k, v, **kw),
                           ref.flash_attention_ref(q, k, v, **kw))
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, v)


# --------------------------------------------------------------------------
# (b) rope, the MLP, the embedding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_rope_matches_reference(bf16):
    """An fp32 rotation (bf16 x promotes), cast back: fp32 to 1e-6 of
    scale (sin and cos of other libraries), bf16 to one rounding
    (2^-8)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 3, 64)).astype(np.float32)
    pos = np.arange(100, 124)
    if bf16:
        x = _bf16(x)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    want = ref_layers.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10_000.0)
    got = layers.rope(torch.tensor(x).to(tdt), torch.tensor(pos), 10_000.0)
    assert got.dtype == tdt
    assert _err(got, want) <= (2 ** -8 if bf16 else 1e-6)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu", "relu_sq"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    cfg, rcfg = _pair(hidden_act=act)
    rp = jax.device_get(ref_layers.init_mlp(jax.random.PRNGKey(1), rcfg,
                                            64, 256))
    p = {k_: torch.tensor(np.ascontiguousarray(np.asarray(v_).T))
         for k_, v_ in rp.items()}
    mine = layers.init_mlp(torch.Generator().manual_seed(0), cfg, 64, 256)
    assert {k_: v_.shape for k_, v_ in mine.items()} == \
        {k_: v_.shape for k_, v_ in p.items()}
    x = _bf16(rng.normal(size=(2, 8, 64)).astype(np.float32))
    for tdt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                          (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        want = ref_layers.apply_mlp(rcfg, jax.tree.map(jnp.asarray, rp),
                                    jnp.asarray(x, jdt))
        got = layers.apply_mlp(cfg, p, torch.tensor(x).to(tdt))
        assert got.dtype == tdt
        assert _err(got, want) <= tol, tdt


def test_scaled_embedding_is_bit_equal():
    """gemma's sqrt(d_model) embedding scale multiplies by the scalar
    rounded to bf16, as JAX's weak typing does: bit-equal."""
    rp = _ref_params(REF_CFG)
    toks = _tokens(4, (B, S))
    want = ref_tfm._embed(REF_CFG, jax.tree.map(jnp.asarray, rp),
                          jnp.asarray(toks))
    got = transformer._embed(CFG, dense_params_from_jax(rp),
                             torch.tensor(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# --------------------------------------------------------------------------
# (c) one dense layer, (d) the model
# --------------------------------------------------------------------------

def test_dense_layer_matches_reference_in_prefill_and_decode():
    rp = _ref_params(REF_CFG)
    lp_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), rp["blocks"])
    lp = dense_params_from_jax(rp)["blocks"][0]
    rng = np.random.default_rng(5)
    x = _bf16(rng.normal(size=(B, S, CFG.d_model)).astype(np.float32))
    x1 = _bf16(rng.normal(size=(B, 1, CFG.d_model)).astype(np.float32))
    pos = np.arange(S)

    want, (wk, wv), _ = ref_tfm._dense_layer_full(
        REF_CFG, lp_ref, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
        is_moe=False, return_kv=True)
    got, (k, v) = transformer._dense_layer_full(
        CFG, lp, torch.tensor(x).to(torch.bfloat16), torch.tensor(pos))
    assert got.dtype == k.dtype == torch.bfloat16
    for g, w in ((got, want), (k, wk), (v, wv)):
        assert _err(g, w) <= BF16_TOL

    # a decode step from the reference's cache of that prefill
    want_c = ref_tfm._kvs_to_cache(REF_CFG, (wk[None], wv[None]),
                                   jnp.asarray(pos), S + 4)["layers"]
    want_c = jax.tree.map(lambda a: a[0], want_c)
    cache = {k_: torch.tensor(np.asarray(v_, np.float32)).to(
        torch.bfloat16 if k_ in ("k", "v") else torch.int32)
        for k_, v_ in want_c.items()}
    want1, want1_c = ref_tfm._dense_layer_decode(
        REF_CFG, lp_ref, jnp.asarray(x1, jnp.bfloat16), want_c,
        is_moe=False)
    got1, got1_c = transformer._dense_layer_decode(
        CFG, lp, torch.tensor(x1).to(torch.bfloat16), cache)
    assert _err(got1, want1) <= BF16_TOL
    _check_cache({"layers": [got1_c]},
                 {"layers": jax.tree.map(lambda a: a[None], want1_c)})
    assert int(cache["idx"]) == S            # the given cache is unchanged


@pytest.mark.parametrize("head_dim", [None, 256])
def test_prefill_and_decode_match_reference(head_dim):
    """Logits within 2^-5 of their largest magnitude, the caches in the
    reference's dtypes and as close; head_dim 256 is gemma's own."""
    cfg, rcfg = _pair(head_dim)
    rp = _ref_params(rcfg)
    jp = jax.tree.map(jnp.asarray, rp)
    params = dense_params_from_jax(rp)
    toks = _tokens(5, (B, S))
    want, want_cache = ref_tfm.prefill(rcfg, jp, {"tokens": jnp.asarray(toks)},
                                       context=S + 4)
    got, cache = transformer.prefill(cfg, params,
                                     {"tokens": torch.tensor(toks)},
                                     context=S + 4)
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab_size)
    assert _err(got, want) <= BF16_TOL
    _check_cache(cache, want_cache)
    for i in range(3):
        nxt = _tokens(6 + i, (B, 1))
        want, want_cache = R.decode_fn(rcfg, S + 4)(jp, want_cache,
                                                    jnp.asarray(nxt))
        got, cache = registry.decode_fn(cfg, S + 4)(params, cache,
                                                    torch.tensor(nxt))
        assert _err(got, want) <= BF16_TOL, i
        _check_cache(cache, want_cache)


def test_decode_from_a_fresh_cache_matches_reference():
    """``init_cache`` past the sliding window allocates only the window
    (a ring), and one decode step from it is the reference's."""
    rp = _ref_params(REF_CFG)
    context = CFG.sliding_window + 36
    want_cache = R.init_cache(REF_CFG, B, context)
    cache = registry.init_cache(CFG, B, context)
    assert cache["layers"][0]["k"].shape == (B, CFG.sliding_window, 1, 64)
    _check_cache(cache, want_cache)
    nxt = _tokens(7, (B, 1))
    want, want_cache = R.decode_fn(REF_CFG, context)(
        jax.tree.map(jnp.asarray, rp), want_cache, jnp.asarray(nxt))
    got, cache = registry.decode_fn(CFG, context)(
        dense_params_from_jax(rp), cache, torch.tensor(nxt))
    assert _err(got, want) <= BF16_TOL
    _check_cache(cache, want_cache)


@pytest.mark.parametrize("prompt", [100, 40])
def test_sliding_window_ring_matches_reference(prompt):
    """A context past the window (64): the prefill keeps the last 64
    positions rolled into ring order (100 tokens), or pads a shorter
    prompt (40), masking the prompt pass with the window; the cache and
    two windowed decode steps are the reference's (as
    ``tests/test_arch_smoke.py::test_sliding_window_prefill_ring``
    drives it)."""
    rp = _ref_params(REF_CFG)
    jp = jax.tree.map(jnp.asarray, rp)
    params = dense_params_from_jax(rp)
    toks = _tokens(8, (1, prompt))
    w = CFG.sliding_window
    want, want_cache = ref_tfm.prefill(REF_CFG, jp,
                                       {"tokens": jnp.asarray(toks)},
                                       context=128, window=w)
    got, cache = transformer.prefill(CFG, params,
                                     {"tokens": torch.tensor(toks)},
                                     context=128, window=w)
    assert cache["layers"][0]["k"].shape[1] == w
    assert _err(got, want) <= BF16_TOL
    _check_cache(cache, want_cache)
    for i in range(2):
        nxt = _tokens(9 + i, (1, 1))
        want, want_cache = ref_tfm.decode_step(REF_CFG, jp, want_cache,
                                               jnp.asarray(nxt), window=w)
        got, cache = transformer.decode_step(CFG, params, cache,
                                             torch.tensor(nxt), window=w)
        assert _err(got, want) <= BF16_TOL, i
        _check_cache(cache, want_cache)


def test_greedy_generate_matches_reference_in_fp32(monkeypatch):
    """The same 8 greedy tokens when both packages compute in fp32 (the
    compute dtype monkeypatched in both, for this test only): the
    prefill, the decode loop, the cache hand-off and the sampling are
    the reference's.  In bf16 a random model's top logits tie within a
    rounding step."""
    monkeypatch.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    rp = _ref_params(REF_CFG)
    toks = _tokens(10, (B, S))
    want, _ = ref_engine.generate(REF_CFG, jax.tree.map(jnp.asarray, rp),
                                  {"tokens": jnp.asarray(toks)}, 8)
    got, info = engine.generate(CFG, dense_params_from_jax(rp),
                                {"tokens": torch.tensor(toks)}, 8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = info["cache"]["layers"][0]
    assert c["k"].dtype == torch.float32 and c["k"].shape[1] == S + 8
    assert int(c["idx"]) == S + 8


def test_port_init_and_serving_params(monkeypatch):
    """The port's own initialisation gives the converted reference
    tree's structure, shapes and dtypes; the one-time bf16 cast of the
    weights keeps the logits and caches bit-equal."""
    rp = _ref_params(REF_CFG)
    mine = registry.init_params(torch.Generator().manual_seed(0), CFG)
    theirs = dense_params_from_jax(rp)
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    fm, ft = flat(mine), flat(theirs)
    assert fm.keys() == ft.keys()
    for key in fm:
        assert fm[key].shape == ft[key].shape and \
            fm[key].dtype == ft[key].dtype, key
    assert mine["blocks"][0]["attn"]["wq"].shape == (4 * 64, CFG.d_model)
    assert not torch.any(mine["blocks"][1]["n2"]["w"])

    toks = {"tokens": torch.tensor(_tokens(11, (B, S)))}
    p16 = registry.serving_params(dense_params_from_jax(rp))
    assert p16["embed"].dtype == torch.bfloat16
    for group, keys in (("attn", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("wi", "wg", "wo"))):
        for key in keys:
            assert p16["blocks"][0][group][key].dtype == torch.bfloat16
    assert p16["blocks"][0]["n1"]["w"].dtype == torch.float32
    assert p16["final_norm"]["w"].dtype == torch.float32
    a, ca = registry.prefill_fn(CFG)(theirs, toks)
    b, cb = registry.prefill_fn(CFG)(p16, toks)
    assert torch.equal(a, b)
    nxt = toks["tokens"][:, :1]
    a, ca = registry.decode_fn(CFG, S + 1)(theirs, ca, nxt)
    b, cb = registry.decode_fn(CFG, S + 1)(p16, cb, nxt)
    assert torch.equal(a, b)
    for x, y in zip(ca["layers"], cb["layers"]):
        assert all(torch.equal(x[k_], y[k_]) for k_ in x)


# --------------------------------------------------------------------------
# (e) the CLI
# --------------------------------------------------------------------------

def test_serve_cli_defaults_to_gemma_reduced_on_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--max-new", "4"]) == 0
    lines = out.getvalue().strip().splitlines()
    stats = json.loads(lines[-1])
    assert stats["arch"] == "gemma-2b" and stats["device"] == "cpu"
    assert stats["layers"] == 2 and stats["d_model"] == 256
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    first = json.loads(lines[1].split(":", 1)[1])
    assert len(first) == 4 and all(0 <= t < CFG.vocab_size for t in first)


def test_serve_cli_default_arch_without_cuda_raises():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--arch", "gemma-2b"])
