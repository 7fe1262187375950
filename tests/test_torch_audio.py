"""The port's audio family (whisper-medium: an encoder over precomputed
frame embeddings, a decoder with cross-attention to it) against the JAX
reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages; the
reference's parameters are drawn with ``jax.random`` at the
scaled-down width (2 encoder and 2 decoder layers, d_model 256, 4 heads
of 64 without grouping, 64 frames, vocab 512, layernorm, tanh-GELU) and
carried over with ``convert.audio_params_from_jax``.  The reference
attends through its jnp chunked version in the encoder (unmasked), the
decoder's self-attention and the cross-attention (unmasked, Sq != Skv,
one query at each decode step); the port through
``ops.flash_attention``'s plain version on the CPU.  bf16 gaps that the
tolerance (2^-5 of the largest magnitude) covers are those of
``tests/test_torch_dense.py``: XLA:CPU computes the tanh-GELU in bf16
step by step, and the reference's attention rounds p to bf16.
"""
import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import scaled_down as ref_scaled_down
from repro.models import attention as ref_attn
from repro.models import registry as R
from repro.models import transformer as ref_tfm
from repro.serve import engine as ref_engine
from repro_torch.configs import get_arch, scaled_down
from repro_torch.convert import audio_params_from_jax
from repro_torch.models import attention, registry, transformer
from repro_torch.serve import engine
from torch_threads import torch_intra_op_threads  # noqa: F401

ARCH = "whisper-medium"
CFG = scaled_down(get_arch(ARCH))
REF_CFG = ref_scaled_down(ref_get_arch(ARCH))
B, S = 2, 16
BF16_TOL = 2 ** -5


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


@pytest.fixture(scope="module")
def ref_params():
    return jax.device_get(jax.jit(R.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), REF_CFG))


def _batch(seed):
    """(port batch, reference batch): S random tokens and bf16-exact
    frame embeddings (B, encoder_seq, D)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    frames = _bf16(rng.normal(size=(B, CFG.encoder_seq, CFG.d_model))
                   .astype(np.float32))
    return ({"tokens": torch.tensor(toks),
             "frames": torch.tensor(frames).to(torch.bfloat16)},
            {"tokens": jnp.asarray(toks),
             "frames": jnp.asarray(frames, jnp.bfloat16)})


def _check_cache(got, want):
    """Slot caches as the dense family's; ``cross_k`` and ``cross_v``
    (a list a layer here, stacked there) in bf16 within BF16_TOL."""
    w = want["layers"]
    assert len(got["layers"]) == w["k"].shape[0] == CFG.num_layers
    for i, c in enumerate(got["layers"]):
        for key in ("k", "v"):
            assert c[key].dtype == torch.bfloat16, key
            assert _err(c[key], w[key][i]) <= BF16_TOL, (i, key)
        np.testing.assert_array_equal(c["pos"].numpy(),
                                      np.asarray(w["pos"][i]))
        assert int(c["idx"]) == int(w["idx"][i])
    for key in ("cross_k", "cross_v"):
        assert want[key].dtype == jnp.bfloat16
        assert len(got[key]) == CFG.num_layers
        for i, t in enumerate(got[key]):
            assert t.dtype == torch.bfloat16, key
            assert t.shape == (B, CFG.encoder_seq, CFG.num_kv_heads,
                               CFG.head_dim)
            assert _err(t, want[key][i]) <= BF16_TOL, (i, key)


def test_whisper_scaled_down_shape():
    assert (CFG.encoder_layers, CFG.encoder_seq, CFG.num_heads,
            CFG.num_kv_heads, CFG.head_dim, CFG.norm,
            CFG.hidden_act) == (2, 64, 4, 4, 64, "layernorm", "gelu")


# --------------------------------------------------------------------------
# (a) the encoder's parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,d", [(64, 256), (1500, 1024)])
def test_sinusoidal_matches_reference(s, d):
    """fp32, sines then cosines: within 2e-4, the fp32 ulp of an angle
    near 1500 rad (the two libraries' pow and sin differ by an ulp, and
    an ulp of the angle moves its sine that far); in bf16 (as the
    encoder adds it) at most one rounding step apart."""
    want = np.asarray(ref_tfm._sinusoidal(s, d))
    got = transformer._sinusoidal(s, d)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 2e-4
    w16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
    assert _err(got.to(torch.bfloat16), w16) <= 2 ** -8


def test_encoder_matches_reference(ref_params):
    """``run_encoder``: sinusoidal positions, 2 layers of unmasked
    attention (no rope) and GELU MLP, the final layernorm; bf16."""
    mine, theirs = _batch(1)
    want = ref_tfm.run_encoder(REF_CFG, jax.tree.map(jnp.asarray,
                                                     ref_params),
                               theirs["frames"])
    got = transformer.run_encoder(CFG, audio_params_from_jax(ref_params),
                                  mine["frames"])
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= BF16_TOL


@pytest.mark.parametrize("sq", [S, 1])
def test_cross_attention_matches_reference(ref_params, sq):
    """``encoder_kv`` and ``cross_attn_apply`` of one decoder layer over
    64 encoder positions: the prefill's S queries and a decode step's
    one."""
    rng = np.random.default_rng(2)
    enc = _bf16(rng.normal(size=(B, CFG.encoder_seq, CFG.d_model))
                .astype(np.float32))
    x = _bf16(rng.normal(size=(B, sq, CFG.d_model)).astype(np.float32))
    lp_ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          ref_params["blocks"]["xattn"])
    lp = audio_params_from_jax(ref_params)["blocks"][0]["xattn"]
    wk, wv = ref_attn.encoder_kv(REF_CFG, lp_ref,
                                 jnp.asarray(enc, jnp.bfloat16))
    k, v = attention.encoder_kv(CFG, lp,
                                torch.tensor(enc).to(torch.bfloat16))
    assert k.dtype == torch.bfloat16
    assert _err(k, wk) <= BF16_TOL and _err(v, wv) <= BF16_TOL
    want = ref_attn.cross_attn_apply(REF_CFG, lp_ref,
                                     jnp.asarray(x, jnp.bfloat16), wk, wv)
    got = attention.cross_attn_apply(
        CFG, lp, torch.tensor(x).to(torch.bfloat16), k, v)
    assert got.shape == (B, sq, CFG.d_model)
    assert _err(got, want) <= BF16_TOL


# --------------------------------------------------------------------------
# (b) the model
# --------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(ref_params):
    """Prefill (encoder, decoder, encoder K/V into the cache) and 3
    decode steps (cross-attention from the cache) in bf16: logits within
    2^-5 of their largest magnitude, the slot caches and ``cross_k`` /
    ``cross_v`` in the reference's dtypes and as close."""
    ctx = S + 4
    ref_prefill = jax.jit(functools.partial(ref_tfm.prefill, REF_CFG),
                          static_argnames=("context",))
    ref_decode = jax.jit(R.decode_fn(REF_CFG, ctx))
    params = audio_params_from_jax(ref_params)
    jp = jax.tree.map(jnp.asarray, ref_params)
    mine, theirs = _batch(5)
    want, want_cache = ref_prefill(jp, theirs, context=ctx)
    got, cache = transformer.prefill(CFG, params, mine, context=ctx)
    assert got.dtype == torch.float32 and got.shape == (B, 1, CFG.vocab_size)
    assert _err(got, want) <= BF16_TOL
    _check_cache(cache, want_cache)
    for i in range(3):
        nxt = np.random.default_rng(6 + i).integers(
            0, CFG.vocab_size, (B, 1)).astype(np.int32)
        want, want_cache = ref_decode(jp, want_cache, jnp.asarray(nxt))
        got, cache = registry.decode_fn(CFG, ctx)(params, cache,
                                                  torch.tensor(nxt))
        assert _err(got, want) <= BF16_TOL, i
        _check_cache(cache, want_cache)


def test_init_cache_is_the_references():
    """Empty slot caches and zero encoder K/V of ``encoder_seq``
    positions, in the reference's shapes and dtypes."""
    want = R.init_cache(REF_CFG, B, S + 4)
    got = registry.init_cache(CFG, B, S + 4)
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "layers"]
    for key in ("cross_k", "cross_v"):
        assert tuple(want[key].shape) == (CFG.num_layers,) + tuple(
            got[key][0].shape)
        assert all(t.dtype == torch.bfloat16 and not torch.any(t)
                   for t in got[key])
    for i, c in enumerate(got["layers"]):
        for key in ("k", "v", "pos", "idx"):
            np.testing.assert_array_equal(_np(c[key]),
                                          _np(want["layers"][key][i]))


def test_greedy_generate_matches_reference_in_fp32(ref_params, monkeypatch):
    """The same 8 greedy tokens when both packages compute in fp32 (the
    compute dtype monkeypatched in both, for this test only): the
    encoder, the decoder, the cross-attention cache's hand-off, the
    decode loop and the sampling are the reference's."""
    monkeypatch.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    mine, theirs = _batch(10)
    want, _ = ref_engine.generate(REF_CFG,
                                  jax.tree.map(jnp.asarray, ref_params),
                                  theirs, 8)
    got, info = engine.generate(CFG, audio_params_from_jax(ref_params),
                                mine, 8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cache = info["cache"]
    assert info["prompt_len"] == S
    assert cache["cross_k"][0].dtype == torch.float32
    assert int(cache["layers"][0]["idx"]) == S + 8


def test_prefill_decode_consistency():
    """The port alone: a decode step after prefill(prompt) gives
    prefill(prompt + token)'s last logits (the encoder K/V read back
    from the cache)."""
    params = registry.init_serving_params(torch.Generator().manual_seed(3),
                                          CFG)
    mine, _ = _batch(14)
    logits1, cache = registry.prefill_fn(CFG)(params, mine, context=S + 4)
    tok = torch.argmax(logits1, -1)
    logits2, _ = registry.decode_fn(CFG, S + 4)(params, cache, tok)
    full, _ = registry.prefill_fn(CFG)(
        params, dict(mine, tokens=torch.cat([mine["tokens"], tok], dim=1)))
    a, b = logits2[:, -1], full[:, -1]
    assert float((a - b).abs().max() / (b.std() + 1e-6)) < 0.1
    assert torch.equal(a.argmax(-1), b.argmax(-1))


# --------------------------------------------------------------------------
# (c) init, serving params, the CLI
# --------------------------------------------------------------------------

def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_port_init_and_serving_params(ref_params):
    """The port's own initialisation gives the converted reference
    tree's structure, shapes and dtypes (``encoder`` and the decoder
    blocks with ``nc`` and ``xattn``); ``init_serving_params`` is
    bit-equal to ``serving_params(init_params(...))`` with the encoder's
    and the cross-attention's matrices in bf16 and every layernorm in
    fp32; the bf16 cast keeps the logits and caches bit-equal."""
    theirs = audio_params_from_jax(ref_params)
    fm = _flat(registry.init_params(torch.Generator().manual_seed(0), CFG))
    ft = _flat(theirs)
    assert fm.keys() == ft.keys()
    for key in fm:
        assert fm[key].shape == ft[key].shape and \
            fm[key].dtype == ft[key].dtype, key
    assert sorted(theirs["blocks"][0]) == ["attn", "mlp", "n1", "n2", "nc",
                                           "xattn"]
    assert sorted(theirs["encoder"]["layers"][1]) == ["attn", "mlp", "n1",
                                                      "n2"]

    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    fa = _flat(registry.serving_params(registry.init_params(g1, CFG)))
    fb = _flat(registry.init_serving_params(g2, CFG))
    assert fa.keys() == fb.keys()
    assert all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
               for k in fa)
    for key, t in fb.items():
        want = (torch.float32 if "'n" in key or "final_norm" in key
                else torch.bfloat16)
        assert t.dtype == want, key

    mine, _ = _batch(11)
    p16 = registry.serving_params(audio_params_from_jax(ref_params))
    la, ca = registry.prefill_fn(CFG)(theirs, mine, context=S + 1)
    lb, cb = registry.prefill_fn(CFG)(p16, mine, context=S + 1)
    assert torch.equal(la, lb)
    nxt = mine["tokens"][:, :1]
    la, ca = registry.decode_fn(CFG, S + 1)(theirs, ca, nxt)
    lb, cb = registry.decode_fn(CFG, S + 1)(p16, cb, nxt)
    assert torch.equal(la, lb)
    for key in ("cross_k", "cross_v"):
        assert all(torch.equal(x, y) for x, y in zip(ca[key], cb[key]))
    for x, y in zip(ca["layers"], cb["layers"]):
        assert all(torch.equal(x[k_], y[k_]) for k_ in x)


def test_serve_cli_draws_frames_for_whisper(monkeypatch):
    """``serve`` draws (B, encoder_seq, D) bf16 frame embeddings beside
    the tokens and prints its JSON line."""
    from repro_torch.launch import serve
    seen = []
    generate = serve.generate

    def spy(cfg, params, batch, *a, **kw):
        seen.append({k: (tuple(v.shape), v.dtype) for k, v in batch.items()})
        return generate(cfg, params, batch, *a, **kw)

    monkeypatch.setattr(serve, "generate", spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--max-new", "4"]) == 0
    assert seen == [{"tokens": ((2, 8), torch.int64),
                     "frames": ((2, CFG.encoder_seq, CFG.d_model),
                                torch.bfloat16)}]
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    assert stats["arch"] == ARCH and stats["layers"] == 2
