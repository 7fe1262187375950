"""The port's LM training (``train/optim.py``, ``data/lm.py``,
``models/layers.py::chunked_cross_entropy``, ``transformer.train_loss``,
``train/step.py``, ``launch/train.py``, the legacy checkpoint API)
against the JAX reference, on the CPU.

Everything runs scaled down (2 layers, d_model 64, at most 4 heads,
vocab 512).  Inputs are made with numpy from a seed and handed to both
packages; the reference's parameters are drawn with ``jax.random`` and
carried over with ``convert.dense_params_from_jax`` (its optimizer
state with ``convert.adamw_state_from_jax``).  The model comparisons run
in fp32, the compute dtype monkeypatched in both packages, except one
in bf16.  The port's attention runs the plain versions here (forward
``flash_attention_lse_ref``, backward ``flash_attention_bwd_ref``); the
reference differentiates its jnp chunked attention.

Tolerances: a loss within 1e-5 relative, each gradient within 1e-4 of
its largest magnitude (fp32 sums in other orders through two layers and
the backward's explicit formulas); in bf16 2^-5 of scale (the two
packages round bf16 at other places: the tanh-GELU, p before p v).
"""
import contextlib
import dataclasses
import functools
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import scaled_down as ref_scaled_down
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.data.lm import SyntheticLM as RefSyntheticLM
from repro.models import layers as ref_layers
from repro.models import registry as R
from repro.models import transformer as ref_tfm
from repro.train import optim as ref_optim
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch, scaled_down
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import adamw_state_from_jax, dense_params_from_jax
from repro_torch.data.lm import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import layers, registry, transformer
from repro_torch.train import optim
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.step import make_eval_step, make_train_step
from torch_threads import torch_intra_op_threads  # noqa: F401

ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b", "paligemma-3b")
B, S = 2, 32
LOSS_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2 ** -5


def _pair(arch):
    """(port cfg, reference cfg) at the test's size; the MoE's capacity
    drops nothing (E / k), so a rounding step moves no token."""
    kw = dict(layers=2, d_model=64)
    cfg, rcfg = scaled_down(get_arch(arch), **kw), ref_scaled_down(
        ref_get_arch(arch), **kw)
    if cfg.is_moe:
        cf = cfg.num_experts / cfg.experts_per_token
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
    return cfg, rcfg


def _bf16(a):
    """fp32 values bf16 holds exactly."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _batch(cfg, seed, b=B, s=S):
    """A numpy train batch: tokens, targets, a mask with zeros, and the
    vlm family's prefix (bf16-exact)."""
    rng = np.random.default_rng(seed)
    n = s - (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, n)).astype(
               np.int32),
           "mask": (rng.random((b, n)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        out["prefix"] = _bf16(rng.normal(
            size=(b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32))
    return out


def _torch_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in batch.items()}


def _err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel(got, want) -> float:
    got = got.detach() if torch.is_tensor(got) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@contextlib.contextmanager
def _compute_dtype(fp32: bool):
    """Both packages' compute dtype fp32 (or left bf16) inside."""
    with pytest.MonkeyPatch.context() as mp:
        if fp32:
            mp.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
        yield


def _port_loss_grads(cfg, params, batch):
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = transformer.train_loss(cfg, params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def model_runs():
    """arch (and "gemma-2b bf16") -> (port loss, metrics, grads; the
    reference's loss, metrics and grads in the port's layout)."""
    out = {}
    for arch, fp32 in [(a, True) for a in ARCHS] + [("gemma-2b", False)]:
        cfg, rcfg = _pair(arch)
        rp = jax.device_get(R.init_params(jax.random.PRNGKey(1), rcfg))
        batch = _batch(cfg, 3)
        with _compute_dtype(fp32):
            fn = jax.jit(jax.value_and_grad(
                functools.partial(ref_tfm.train_loss, rcfg), has_aux=True))
            (loss, metrics), grads = fn(
                rp, {k: jnp.asarray(v) for k, v in batch.items()})
            mine = _port_loss_grads(cfg, dense_params_from_jax(rp), batch)
        want_grads = optim.tree_leaves(
            dense_params_from_jax(jax.device_get(grads)))
        out[arch if fp32 else arch + " bf16"] = (
            mine, (float(loss), jax.device_get(metrics), want_grads))
    return out


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

STEPS = [0, 1, 5, 99, 100, 101, 4999, 8999, 9000, 9001, 9500, 10000, 10001]


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_lr_matches_reference(schedule):
    """Each step's rate, across warmup, the cosine and the WSD decay
    start, within 1e-6 relative (the same fp32 operations)."""
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=10_000,
              schedule=schedule)
    cfg, rcfg = optim.OptConfig(**kw), ref_optim.OptConfig(**kw)
    for step in STEPS:
        want = float(ref_optim.schedule_lr(rcfg, jnp.int32(step)))
        got = float(optim.schedule_lr(cfg, torch.tensor(step, dtype=torch.int32)))
        assert _rel(got, want) <= 1e-6 or got == want == 0.0, step


def _random_tree(rp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(
        np.float32), rp)


def test_adamw_update_matches_reference():
    """Two AdamW steps on converted parameters (norm weights made
    nonzero) and state, the gradients clipped: parameters, m, v, lr and
    the global norm within 1e-6 of each leaf's scale."""
    _, rcfg = _pair("gemma-2b")
    rp = jax.device_get(R.init_params(jax.random.PRNGKey(0), rcfg))
    rp = jax.tree.map(lambda a, r: a + 0.1 * r, rp, _random_tree(rp, 1))
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_state = ref_optim.adamw_init(rp)
    params = dense_params_from_jax(rp)
    state = adamw_state_from_jax(jax.device_get(ref_state))
    ref_step = jax.jit(functools.partial(ref_optim.adamw_update,
                                         ref_optim.OptConfig(**ocfg)))
    for i in range(2):
        rg = _random_tree(rp, 10 + i)
        rp, ref_state, rm = ref_step(rg, ref_state, rp)
        params, state, m = optim.adamw_update(
            optim.OptConfig(**ocfg), dense_params_from_jax(rg), state, params)
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        assert _rel(m["lr"], rm["lr"]) <= 1e-6
        assert _rel(m["grad_norm"], rm["grad_norm"]) <= 1e-6
        assert float(rm["grad_norm"]) > 1.0          # the clip is active
        for got, want in ((params, rp), (state["m"], ref_state["m"]),
                          (state["v"], ref_state["v"])):
            want = optim.tree_leaves(dense_params_from_jax(
                jax.device_get(want)))
            for a, w in zip(optim.tree_leaves(got), want):
                assert _err(a, w.numpy()) <= 1e-6


def test_adamw_decays_the_references_matrices_only():
    """With zero gradients a step is decay alone: the top-level norm
    (a vector in the reference too) keeps its values; the embedding,
    every dense weight and, as in the reference, whose layer stack makes
    them rows of (L, D) matrices, the per-layer norm weights shrink by
    lr * weight_decay."""
    cfg, _ = _pair("gemma-2b")
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    params = optim.tree_map(lambda t: t + 0.5, params)
    before = optim.tree_map(torch.clone, params)
    ocfg = optim.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    zeros = optim.tree_map(torch.zeros_like, params)
    optim.adamw_update(ocfg, zeros, optim.adamw_init(params), params)
    shrink = 1 - 0.1 * 0.5
    assert torch.equal(params["final_norm"]["w"], before["final_norm"]["w"])
    for got, was in ((params["embed"], before["embed"]),
                     (params["blocks"][0]["attn"]["wq"],
                      before["blocks"][0]["attn"]["wq"]),
                     (params["blocks"][1]["n1"]["w"],
                      before["blocks"][1]["n1"]["w"])):
        torch.testing.assert_close(got, was * shrink, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# data and the loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b",
                                  "whisper-medium"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_lm_matches_reference(arch, seed):
    """The same tokens, targets, masks and vlm/audio embeddings, bit for
    bit, over two batches."""
    cfg, rcfg = scaled_down(get_arch(arch)), ref_scaled_down(
        ref_get_arch(arch))
    ours = SyntheticLM(cfg.vocab_size, seed=seed).batches(3, 40, cfg)
    theirs = RefSyntheticLM(rcfg.vocab_size, seed=seed).batches(3, 40, rcfg)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_concrete_batch_has_the_references_spec():
    for arch in ARCHS + ("whisper-medium",):
        cfg, rcfg = _pair(arch)
        got = registry.make_concrete_batch(
            cfg, ShapeConfig("t", 40, 3, "train"),
            torch.Generator().manual_seed(0), "train")
        want = R.train_batch_spec(rcfg, RefShapeConfig("t", 40, 3, "train"))
        assert list(got) == list(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, (arch, k)


@pytest.mark.parametrize("s,softcap,tied", [
    (1024, 0.0, True),       # two chunks of 512
    (1200, 30.0, True),      # two chunks of 600, soft-capped
    (96, 0.0, False),        # one chunk, an untied head
])
def test_chunked_cross_entropy_matches_reference(s, softcap, tied):
    """(sum of masked NLL, sum of the mask) within 1e-5 relative, and
    the gradients of the sum with respect to x and the head within 1e-5
    of their scale, in fp32."""
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    w = (0.2 * rng.normal(size=(512, 32))).astype(np.float32)
    labels = rng.integers(0, 512, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) > 0.3).astype(np.float32)

    def ref(x, w):
        kw = dict(head=w.T) if not tied else {}
        return ref_layers.chunked_cross_entropy(
            x, w, jnp.asarray(labels), jnp.asarray(mask), softcap=softcap,
            **kw)
    (tot, cnt), vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp((jnp.float32(1.0), jnp.float32(0.0)))

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    kw = dict(head=wt) if not tied else {}
    got, n = layers.chunked_cross_entropy(
        xt, wt, torch.tensor(labels).long(), torch.tensor(mask),
        softcap=softcap, **kw)
    got.backward()
    assert _rel(got, tot) <= 1e-5 and float(n) == float(cnt)
    assert _err(xt.grad, gx) <= 1e-5
    assert _err(wt.grad, gw) <= 1e-5


# --------------------------------------------------------------------------
# the model's loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(model_runs, arch):
    """fp32: the loss and its metrics (the MoE's lb_loss and z_loss,
    summed over the layers, among them) within 1e-5 relative, the token
    count equal, every parameter's gradient within 1e-4 of its scale."""
    (loss, metrics, grads), (rloss, rmetrics, rgrads) = model_runs[arch]
    assert _rel(loss, rloss) <= LOSS_TOL
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    for k in ("ce", "loss", "lb_loss", "z_loss"):
        assert _rel(metrics[k], rmetrics[k]) <= LOSS_TOL or (
            float(metrics[k]) == float(rmetrics[k]) == 0.0), k
    if arch.startswith("qwen3"):
        assert float(rmetrics["lb_loss"]) > 0 and float(
            rmetrics["z_loss"]) > 0
    assert len(grads) == len(rgrads)
    for g, w in zip(grads, rgrads):
        assert _err(g, w.numpy()) <= GRAD_TOL


def test_train_loss_and_grads_match_reference_in_bf16(model_runs):
    """bf16 compute (fp32 parameters), gemma-2b: loss and gradients
    within 2^-5 of scale."""
    (loss, _, grads), (rloss, _, rgrads) = model_runs["gemma-2b bf16"]
    assert _rel(loss, rloss) <= BF16_TOL
    for g, w in zip(grads, rgrads):
        assert _err(g, w.numpy()) <= BF16_TOL


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _ref_tree():
    _, rcfg = _pair("gemma-2b")
    return jax.device_get(R.init_params(jax.random.PRNGKey(2), rcfg))


def test_grad_accum_equivalence():
    """ga = 2 over a batch against ga = 1 over the same batch, as the
    reference's ``test_grad_accum_equivalence`` (the same bound)."""
    cfg, _ = _pair("gemma-2b")
    rp = _ref_tree()
    batch = _torch_batch(_batch(cfg, 5, b=4))
    batch["mask"] = torch.ones_like(batch["mask"])
    opt = optim.OptConfig(lr=1e-2, grad_clip=0.0, weight_decay=0.0)
    out = []
    for ga in (1, 2):
        params = dense_params_from_jax(rp)
        step = make_train_step(cfg, ShapeConfig("t", S, 4, "train",
                                                grad_accum=ga), opt)
        out.append(step(params, optim.adamw_init(params), batch))
    d = max(float((a - b).abs().max()) for a, b in zip(
        optim.tree_leaves(out[0][0]), optim.tree_leaves(out[1][0])))
    assert d < 5e-3, d
    assert _rel(out[0][2]["loss"], out[1][2]["loss"]) <= 1e-5


def test_train_step_matches_reference_over_two_steps():
    """fp32, ga = 2, the clip and the decay active: each step's loss,
    grad_norm and lr within 1e-5 relative, the token count equal, and
    each parameter within 1e-4 of the largest element of its update, as
    the gradients, plus the rounding of the two updated values (2^-22
    of the parameter).  AdamW's eps is 1 here, so each element's step is
    linear in its gradient: at the default 1e-8, Adam divides each
    gradient by its own magnitude, and an element whose gradient lies
    within rounding of zero steps by up to lr either way."""
    cfg, rcfg = _pair("gemma-2b")
    rp = _ref_tree()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=0.5,
              eps=1.0)
    shape = dict(seq_len=S, global_batch=4, kind="train", grad_accum=2)
    batches = [_batch(cfg, 20 + i, b=4) for i in range(2)]
    with _compute_dtype(True):
        ref_step = jax.jit(ref_make_train_step(
            rcfg, RefShapeConfig("t", **shape), ref_optim.OptConfig(**kw)))
        rstate = ref_optim.adamw_init(rp)
        params = dense_params_from_jax(rp)
        state = optim.adamw_init(params)
        step = make_train_step(cfg, ShapeConfig("t", **shape),
                               optim.OptConfig(**kw))
        rparams = rp
        for batch in batches:
            before = optim.tree_map(torch.clone, params)
            rparams, rstate, rm = ref_step(
                rparams, rstate, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
            params, state, m = step(params, state, _torch_batch(batch))
            for k in ("loss", "grad_norm", "lr", "ce"):
                assert _rel(m[k], rm[k]) <= 1e-5, k
            assert float(m["tokens"]) == float(rm["tokens"])
            want = optim.tree_leaves(dense_params_from_jax(
                jax.device_get(rparams)))
            for a, w, p0 in zip(optim.tree_leaves(params), want,
                                optim.tree_leaves(before)):
                tol = (GRAD_TOL * float((w - p0).abs().max())
                       + 2 ** -22 * w.abs())
                assert bool(((a - w).abs() <= tol).all())


def test_eval_step_is_the_losss_metrics():
    cfg, _ = _pair("paligemma-3b")
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _torch_batch(_batch(cfg, 4))
    got = make_eval_step(cfg)(params, batch)
    _, want = transformer.train_loss(cfg, params, batch)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k].detach()), k


# --------------------------------------------------------------------------
# the CLI and the legacy checkpoint
# --------------------------------------------------------------------------

def test_train_cli_prints_the_references_lines(tmp_path):
    """``--reduced --device cpu --steps 3``: the reference's header (its
    parameter count, from the reference's own init shapes) and step
    lines, then the JSON line; ``--ckpt`` writes a checkpoint that loads
    back into the port's tree."""
    ck = tmp_path / "ck"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_cli.main(["--reduced", "--device", "cpu", "--steps",
                               "3", "--batch", "2", "--seq", "32",
                               "--log-every", "2", "--ckpt", str(ck)]) == 0
    lines = buf.getvalue().splitlines()
    rcfg = ref_scaled_down(ref_get_arch("gemma-2b"), layers=4, d_model=256)
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jax.eval_shape(
        lambda: R.init_params(jax.random.PRNGKey(0), rcfg))))
    assert lines[0] == f"[train] gemma-2b: {n / 1e6:.1f}M params (reduced)"
    pat = (r"\[train\] step +(\d+) loss \d+\.\d{4} ce \d+\.\d{4} lr "
           r"\d\.\d{2}e-\d\d gnorm \d+\.\d{2} \(\d+\.\d{2}s/step\)$")
    steps = [int(re.match(pat, ln).group(1)) for ln in lines[1:3]]
    assert steps == [0, 2]
    assert lines[3] == f"[train] checkpoint -> {ck}"
    stats = json.loads(lines[4])
    assert stats["arch"] == "gemma-2b" and len(stats["step_s"]) == 3
    assert all(np.isfinite(stats["loss"]))
    cfg = scaled_down(get_arch("gemma-2b"), layers=4, d_model=256)
    like = registry.init_params(torch.Generator().manual_seed(1), cfg)
    params, opt, step = load_checkpoint(str(ck), like,
                                        optim.adamw_init(like))
    assert step == 3 and int(opt["step"]) == 3


def test_legacy_checkpoint_round_trip_and_mismatch(tmp_path):
    cfg, _ = _pair("qwen3-moe-30b-a3b")
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    state = optim.adamw_init(params)
    state["m"]["embed"].normal_()
    save_checkpoint(str(tmp_path), params, state, step=7,
                    extra={"arch": cfg.name})
    like = optim.tree_map(torch.zeros_like, params)
    got, opt, step = load_checkpoint(str(tmp_path), like,
                                     optim.adamw_init(like))
    assert step == 7
    for a, b in zip(optim.tree_leaves((params, state)),
                    optim.tree_leaves((got, opt))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the structure of another config, a shape, a dtype: each raises
    other = registry.init_params(torch.Generator().manual_seed(0),
                                 _pair("gemma-2b")[0])
    with pytest.raises(ValueError, match="params structure mismatch"):
        load_checkpoint(str(tmp_path), other)
    like["blocks"][1]["moe"]["wo"] = like["blocks"][1]["moe"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="blocks/1/moe/wo"):
        load_checkpoint(str(tmp_path), like)
    like = optim.tree_map(torch.zeros_like, params)
    like["final_norm"]["w"] = like["final_norm"]["w"].double()
    with pytest.raises(ValueError, match="final_norm"):
        load_checkpoint(str(tmp_path), like)
