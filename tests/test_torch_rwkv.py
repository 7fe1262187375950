"""The port's RWKV-6 serving path against the JAX reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages; the
reference's parameters are drawn with ``jax.random`` and carried over
with ``convert.rwkv_params_from_jax``.  The model-level reference is
its default implementation (``wkv6_chunked``); its Pallas path cannot
run through the model (ROADMAP C6), so ``wkv6_pallas`` is called
directly, in interpret mode, as ``tests/test_kernels.py`` does.  No
test sets ``REPRO_KERNEL_IMPL``.  Everything runs at the scaled-down
width (2 layers, d_model 256, vocab 512, head size 64) or smaller.
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
from repro.kernels import ref as kref
from repro.kernels.wkv6 import wkv6_pallas
from repro.models import registry as R
from repro.models import rwkv6 as ref_rwkv
from repro.serve import engine as ref_engine
from repro_torch.configs import ARCH_IDS, get_arch, scaled_down
from repro_torch.convert import rwkv_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import registry, rwkv6
from repro_torch.serve import engine
from torch_threads import torch_intra_op_threads  # noqa: F401

CFG = scaled_down(get_arch("rwkv6-3b"))
REF_CFG = ref_scaled_down(ref_get_arch("rwkv6-3b"))
B, S = 2, 16


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 holds exactly, so both packages start from
    the same bf16 inputs."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _err(got, want) -> float:
    """Max abs error over the reference's largest magnitude (fp32
    numpy views of either package's tensors)."""
    got = (got.float().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def ref_params():
    return jax.device_get(R.init_params(jax.random.PRNGKey(0), REF_CFG))


@pytest.fixture(scope="module")
def params(ref_params):
    return rwkv_params_from_jax(ref_params)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def test_configs_are_the_references():
    for arch in ARCH_IDS:
        assert (dataclasses.asdict(get_arch(arch))
                == dataclasses.asdict(ref_get_arch(arch)))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)
    from repro.configs import ShapeConfig as RefShape
    from repro_torch.configs import ShapeConfig
    assert ([(f.name, f.default) for f in dataclasses.fields(ShapeConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(RefShape)])
    assert (CFG.num_layers, CFG.d_model, CFG.vocab_size,
            CFG.rwkv_head_size) == (2, 256, 512, 64)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    """fp32 normalisation of a bf16 input, rounded back to bf16: equal
    up to one bf16 rounding (2^-8 of the largest magnitude)."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(11)
    x = _bf16(rng.normal(3.0, 2.0, (3, 5, 64)).astype(np.float32))
    cfg = dataclasses.replace(CFG, norm=norm)
    p = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in jax.device_get(ref_layers.init_norm(cfg, 64)).items()}
    assert {k: v.shape for k, v in layers.init_norm(cfg, 64).items()} == \
        {k: v.shape for k, v in p.items()}
    want = ref_layers.apply_norm(cfg, p, jnp.asarray(x, jnp.bfloat16))
    got = layers.apply_norm(cfg, {k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= 2 ** -8


# --------------------------------------------------------------------------
# (a) the kernel's plain version
# --------------------------------------------------------------------------

def _wkv_inputs(b, t, h, n, seed, bf16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32)
               for _ in range(3))
    if bf16:
        r, k, v = _bf16(r), _bf16(k), _bf16(v)
    # decays over (0.37, 0.9975), as exp(-exp(w0 + lora)) gives them
    w = np.exp(-np.exp(rng.uniform(-6, 0, (b, t, h, n)))).astype(np.float32)
    u = (0.5 * rng.normal(size=(h, n))).astype(np.float32)
    s0 = rng.normal(size=(b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t,h", [(2, 64, 2), (1, 256, 2)])
def test_wkv6_plain_matches_reference_and_pallas(b, t, h, bf16):
    """fp32 recurrences summed in other orders: y and sT within 1e-5 of
    the largest |y| and |sT| (the state reaches ~1/(1 - w) ~ 400 times
    one step's k v^T, and fp32 keeps ~1e-7 of it per step).  T = 256
    runs two of the Pallas kernel's 128-step chunks, so the carry
    across chunks is checked too."""
    r, k, v, w, u, s0 = _wkv_inputs(b, t, h, 64, b * t + bf16, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tr, tk, tv = (torch.tensor(z).to(dt) for z in (r, k, v))
    y, s_t = ref.wkv6_ref(tr, tk, tv, torch.tensor(w), torch.tensor(u),
                          torch.tensor(s0))
    assert y.dtype == s_t.dtype == torch.float32
    jr, jk, jv = (jnp.asarray(z, jdt) for z in (r, k, v))
    for want_y, want_s in (
            kref.wkv6_ref(jr, jk, jv, w, u, s0),
            wkv6_pallas(jr, jk, jv, w, u, s0, interpret=True)):
        assert _err(y, want_y) <= 1e-5
        assert _err(s_t, want_s) <= 1e-5
    # the op returns y in r's dtype and the state in fp32
    y_op, s_op = ops.wkv6(tr, tk, tv, torch.tensor(w), torch.tensor(u),
                          torch.tensor(s0))
    assert y_op.dtype == dt and s_op.dtype == torch.float32
    assert torch.equal(y_op, y.to(dt)) and torch.equal(s_op, s_t)


def test_wkv6_cuda_refuses_cpu_tensors():
    from repro_torch.kernels.wkv6 import wkv6_cuda
    z = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_cuda(z, z, z, z, torch.zeros(1, 64), torch.zeros(1, 1, 64, 64))


# --------------------------------------------------------------------------
# (b) one block
# --------------------------------------------------------------------------

# bf16 tolerance: the two packages round bf16 at other places (XLA may
# keep fused elementwise chains in fp32), so a value moves by a few
# bf16 ulps (2^-8 relative each) through the block's ~10 bf16 ops
BF16_TOL = 2 ** -5


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree["blocks"])


def test_block_matches_reference_in_prefill_and_decode(ref_params, params):
    rng = np.random.default_rng(3)
    x = _bf16(rng.normal(size=(B, S, CFG.d_model)).astype(np.float32))
    x1 = _bf16(rng.normal(size=(B, 1, CFG.d_model)).astype(np.float32))
    lp_ref = _layer(ref_params, 0)
    norms_ref = {"n1": lp_ref["n1"]["w"], "n2": lp_ref["n2"]["w"]}
    lp = params["blocks"][0]
    norms = {"n1": lp["n1"]["w"], "n2": lp["n2"]["w"]}

    want, want_st = ref_rwkv.rwkv_layer_apply(
        REF_CFG, lp_ref["rwkv"], norms_ref, jnp.asarray(x, jnp.bfloat16),
        None)
    got, got_st = rwkv6.rwkv_layer_apply(
        CFG, lp["rwkv"], norms, torch.tensor(x).to(torch.bfloat16), None)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= BF16_TOL
    for key, dt in (("x_tm", torch.bfloat16), ("x_cm", torch.bfloat16),
                    ("S", torch.float32)):
        assert got_st[key].dtype == dt
        assert _err(got_st[key], want_st[key]) <= BF16_TOL, key

    # a decode step (T == 1, plain ops) from the reference's state
    st = {k_: torch.tensor(np.asarray(v_, np.float32)).to(got_st[k_].dtype)
          for k_, v_ in want_st.items()}
    want1, want1_st = ref_rwkv.rwkv_layer_apply(
        REF_CFG, lp_ref["rwkv"], norms_ref, jnp.asarray(x1, jnp.bfloat16),
        want_st)
    got1, got1_st = rwkv6.rwkv_layer_apply(
        CFG, lp["rwkv"], norms, torch.tensor(x1).to(torch.bfloat16), st)
    assert _err(got1, want1) <= BF16_TOL
    for key in ("x_tm", "x_cm", "S"):
        assert _err(got1_st[key], want1_st[key]) <= BF16_TOL, key


# --------------------------------------------------------------------------
# (c) prefill and decode of the scaled-down model, (d) generate
# --------------------------------------------------------------------------

def _stacked(cache):
    return {k: torch.stack([st[k] for st in cache["layers"]])
            for k in ("x_tm", "x_cm", "S")}


def _check_cache(got, want):
    got = _stacked(got)
    for key, dt, jdt in (("x_tm", torch.bfloat16, jnp.bfloat16),
                         ("x_cm", torch.bfloat16, jnp.bfloat16),
                         ("S", torch.float32, jnp.float32)):
        assert got[key].dtype == dt, key
        assert want["layers"][key].dtype == jdt, key
        assert _err(got[key], want["layers"][key]) <= BF16_TOL, key


def test_prefill_and_decode_match_reference(ref_params, params):
    """Logits within 2^-5 of their largest magnitude (bf16 rounding in
    other places through 2 blocks and the head), the cache in the
    reference's dtypes (x_tm, x_cm bf16; S fp32) and as close."""
    toks = _tokens(5, (B, S))
    want, want_cache = R.prefill_fn(REF_CFG)(
        jax.tree.map(jnp.asarray, ref_params), {"tokens": jnp.asarray(toks)})
    got, cache = registry.prefill_fn(CFG)(params,
                                          {"tokens": torch.tensor(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, 1, CFG.vocab_size)
    assert _err(got, want) <= BF16_TOL
    _check_cache(cache, want_cache)

    nxt = _tokens(6, (B, 1))
    want1, want1_cache = R.decode_fn(REF_CFG, S + 1)(
        jax.tree.map(jnp.asarray, ref_params), want_cache, jnp.asarray(nxt))
    got1, cache1 = registry.decode_fn(CFG, S + 1)(params, cache,
                                                  torch.tensor(nxt))
    assert got1.shape == (B, 1, CFG.vocab_size)
    assert _err(got1, want1) <= BF16_TOL
    _check_cache(cache1, want1_cache)


def test_decode_from_a_fresh_cache_matches_reference(ref_params, params):
    """``init_cache`` (fp32 zero states) through one decode step."""
    nxt = _tokens(7, (B, 1))
    want, _ = R.decode_fn(REF_CFG, 4)(
        jax.tree.map(jnp.asarray, ref_params), R.init_cache(REF_CFG, B, 4),
        jnp.asarray(nxt))
    got, _ = registry.decode_fn(CFG, 4)(
        params, registry.init_cache(CFG, B, 4), torch.tensor(nxt))
    assert _err(got, want) <= BF16_TOL


def test_greedy_generate_matches_reference_in_fp32(ref_params, params,
                                                  monkeypatch):
    """The same 8 greedy tokens when both packages compute in fp32 (the
    compute dtype monkeypatched in both, for this test only): the
    prefill, the decode loop, the cache hand-off and the sampling are
    the reference's.  In bf16 a random model's top logits tie within a
    rounding step, so the bf16 test below compares decisive steps."""
    from repro.models import transformer as ref_tfm
    from repro_torch.models import transformer
    monkeypatch.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    toks = _tokens(8, (B, S))
    want, _ = ref_engine.generate(REF_CFG, jax.tree.map(jnp.asarray,
                                                        ref_params),
                                  {"tokens": jnp.asarray(toks)}, 8)
    got, info = engine.generate(CFG, params, {"tokens": torch.tensor(toks)},
                                8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info["prompt_len"] == S and len(info["cache"]["layers"]) == 2
    assert info["cache"]["layers"][0]["x_tm"].dtype == torch.float32


def test_greedy_steps_match_reference_in_bf16(ref_params, params):
    """The reference's greedy tokens, fed to both packages step by step
    (8 steps: the prefill and 7 decodes): every step's logits within
    BF16_TOL of their largest magnitude, and the port's argmax equal to
    the reference's token wherever the reference's top-2 gap exceeds
    twice that bound, where no rounding inside the bound can flip it."""
    jp = jax.tree.map(jnp.asarray, ref_params)
    toks = _tokens(8, (B, S))
    want_toks, _ = ref_engine.generate(REF_CFG, jp,
                                       {"tokens": jnp.asarray(toks)}, 8)
    want_toks = np.asarray(want_toks)
    want, want_cache = R.prefill_fn(REF_CFG)(jp, {"tokens": jnp.asarray(toks)})
    got, cache = registry.prefill_fn(CFG)(params,
                                          {"tokens": torch.tensor(toks)})
    step_ref, step = R.decode_fn(REF_CFG, S + 8), registry.decode_fn(CFG,
                                                                     S + 8)
    decisive = 0
    for i in range(8):
        w = np.asarray(want, np.float32)[:, -1]
        assert _err(got, want) <= BF16_TOL, i
        np.testing.assert_array_equal(w.argmax(-1), want_toks[:, i])
        top2 = np.sort(w, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL * np.abs(w).max()
        mine = got[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(mine[sure], want_toks[sure, i])
        decisive += int(sure.sum())
        nxt = want_toks[:, i:i + 1]
        want, want_cache = step_ref(jp, want_cache, jnp.asarray(nxt))
        got, cache = step(params, cache, torch.tensor(nxt))
    assert decisive >= B * 8 // 4


def test_serving_params_keep_the_numbers(ref_params):
    """The one-time bf16 cast gives bit-equal logits and caches."""
    toks = {"tokens": torch.tensor(_tokens(9, (B, S)))}
    p32 = rwkv_params_from_jax(ref_params)
    p16 = registry.serving_params(rwkv_params_from_jax(ref_params))
    assert p16["blocks"][0]["rwkv"]["wr"].dtype == torch.bfloat16
    assert p16["blocks"][0]["rwkv"]["u"].dtype == torch.float32
    a, ca = registry.prefill_fn(CFG)(p32, toks)
    b, cb = registry.prefill_fn(CFG)(p16, toks)
    assert torch.equal(a, b)
    for x, y in zip(_stacked(ca).values(), _stacked(cb).values()):
        assert torch.equal(x, y)


def test_other_families_raise():
    """The hybrid family's cache holds a slot cache and a mamba state;
    the MoE's expert-parallel path raises naming A11."""
    from repro_torch.models import moe
    jamba = scaled_down(get_arch("jamba-v0.1-52b"))
    cache = registry.init_cache(jamba, 1, 4)
    assert [sorted(c) for c in cache["layers"]] == [
        ["idx", "k", "pos", "v"], ["conv", "h"]]
    with pytest.raises(NotImplementedError, match="A11"):
        moe._apply_moe_ep(jamba, {}, torch.zeros(1, 1, jamba.d_model))


def test_port_init_has_the_references_shapes_and_dtypes(ref_params):
    """The port's own initialisation (a torch.Generator) gives the
    converted reference tree's structure, shapes and dtypes, and the
    rmsnorm weights stored minus one (zeros)."""
    mine = registry.init_params(torch.Generator().manual_seed(0), CFG)
    theirs = rwkv_params_from_jax(ref_params)
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    fm, ft = flat(mine), flat(theirs)
    assert fm.keys() == ft.keys()
    for key in fm:
        assert fm[key].shape == ft[key].shape and fm[key].dtype == \
            ft[key].dtype, key
    assert not torch.any(mine["blocks"][1]["n2"]["w"])


# --------------------------------------------------------------------------
# (e) the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_cli_runs_reduced_on_cpu(temperature):
    from repro_torch.launch import serve
    argv = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--max-new", "4", "--temperature",
            temperature]
    runs = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert serve.main(argv) == 0
        runs.append(out.getvalue().strip().splitlines())
    stats = json.loads(runs[0][-1])
    assert stats["device"] == "cpu" and stats["layers"] == 2
    assert stats["arch"] == "rwkv6-3b"
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    # one seed, the same tokens (sampled ones too)
    first = [json.loads(r[1].split(":", 1)[1]) for r in runs]
    assert first[0] == first[1] and len(first[0]) == 4
    assert all(0 <= t < CFG.vocab_size for t in first[0])


def test_serve_cli_without_cuda_raises():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--arch", "rwkv6-3b"])
