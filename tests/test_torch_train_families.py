"""Training of the ssm, hybrid and audio families (rwkv6-3b,
jamba-v0.1-52b, whisper-medium) against the JAX reference, on the CPU.

The backward sweeps' plain versions (``kernels/ref.py::wkv6_bwd_ref``,
``selective_scan_bwd_ref``), which the CPU path and the card's checks
use, are held against ``jax.vjp`` of the reference's scans
(``repro.models.rwkv6.wkv6_chunked``, its default path, and
``repro.kernels.ref.wkv6_ref``; ``repro.models.mamba._ssm_scan``) and
against ``torch.autograd`` through the port's forward plain versions,
about the kernels' 64-step chunks and with the final state's gradient
given and not; the autograd Functions of ``kernels/ops.py`` pass every
input's gradient on.  Then ``transformer.train_loss`` and its gradients,
and one ``make_train_step`` update, of each family scaled down (2
layers, d_model 64 (128 for rwkv6: 2 heads of 64), vocab 512) against
the reference's in fp32 (the compute dtype monkeypatched in both
packages); the reference's parameters are drawn with ``jax.random`` and
carried over with ``convert``.  Inputs are made with numpy from a seed.

Tolerances: a plain backward within 1e-5 of each gradient's largest
magnitude of ``jax.vjp`` of the per-step scans and of autograd (fp32
sums in other orders), 1e-4 of the chunked matmul form (its decays go
through log and exp); a loss within 1e-5 relative, each model gradient
within 1e-4 of its largest magnitude, each parameter within 1e-4 of its
update's largest element (AdamW's eps at 1, as
``tests/test_torch_train.py`` holds gemma-2b's step).
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

from repro.configs import get_arch as ref_get_arch
from repro.configs import scaled_down as ref_scaled_down
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.kernels import ref as ref_kref
from repro.models import mamba as ref_mamba
from repro.models import registry as R
from repro.models import rwkv6 as ref_rwkv
from repro.models import transformer as ref_tfm
from repro.train import optim as ref_optim
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import get_arch, scaled_down
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from torch_threads import torch_intra_op_threads  # noqa: F401

ARCHS = ("rwkv6-3b", "jamba-v0.1-52b", "whisper-medium")
CONVERT = {"rwkv6-3b": convert.rwkv_params_from_jax,
           "jamba-v0.1-52b": convert.hybrid_params_from_jax,
           "whisper-medium": convert.audio_params_from_jax}
B, S = 2, 32
SCAN_TOL, CHUNKED_TOL = 1e-5, 1e-4
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=0.5, eps=1.0)


def _err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# --------------------------------------------------------------------------
# the plain backward sweeps
# --------------------------------------------------------------------------

def _wkv_inputs(b, t, h, seed, with_ds):
    """r, k, v, w, u, s0 and the cotangents dy, dsT (None unless
    ``with_ds``), numpy fp32; decays over (0.37, 0.9975)."""
    rng = np.random.default_rng(seed)
    n = 64
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    w = np.exp(-np.exp(rng.random((b, t, h, n)) * 6 - 6)).astype(np.float32)
    ins = [f(b, t, h, n), f(b, t, h, n), f(b, t, h, n), w,
           (0.5 * f(h, n)).astype(np.float32), f(b, h, n, n)]
    return ins, f(b, t, h, n), (f(b, h, n, n) if with_ds else None)


def _scan_inputs(b, t, di, n, seed, with_dh):
    """x, dt, B, C, a, h0 and the cotangents dy, dhT (None unless
    ``with_dh``), numpy fp32; dt a softplus of small values, a < 0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(f(b, t, di) - 4)).astype(np.float32)
    a = (-np.exp(0.5 * f(di, n))).astype(np.float32)
    ins = [f(b, t, di), dt, f(b, t, n), f(b, t, n), a,
           (0.1 * f(b, di, n)).astype(np.float32)]
    return ins, f(b, t, di), (f(b, di, n) if with_dh else None)


def _jax_vjp(fn, ins, dy, ds):
    (y, s_t), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in ins))
    cot = (jnp.asarray(dy),
           jnp.zeros_like(s_t) if ds is None else jnp.asarray(ds))
    return [np.asarray(g) for g in vjp(cot)]


WKV_CASES = [(1, 5, 2, False), (2, 64, 1, True), (1, 65, 2, True),
             (2, 129, 1, False)]


@pytest.mark.parametrize("fn", ["wkv6_chunked", "wkv6_ref"])
@pytest.mark.parametrize("b,t,h,with_ds", WKV_CASES)
def test_wkv6_bwd_ref_matches_jax_vjp(fn, b, t, h, with_ds):
    """dr, dk, dv, dw, du and ds0 against ``jax.vjp`` of the reference's
    default path (the chunked matmul form) and of its per-step oracle."""
    ins, dy, ds = _wkv_inputs(b, t, h, t, with_ds)
    ref_fn = (ref_rwkv.wkv6_chunked if fn == "wkv6_chunked"
              else ref_kref.wkv6_ref)
    want = _jax_vjp(ref_fn, ins, dy, ds)
    got = ref.wkv6_bwd_ref(*(torch.tensor(a) for a in ins), torch.tensor(dy),
                           None if ds is None else torch.tensor(ds))
    tol = CHUNKED_TOL if fn == "wkv6_chunked" else SCAN_TOL
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert _err(g, w) <= tol, name


SCAN_CASES = [(1, 5, 16, 16, False), (2, 64, 24, 16, True),
              (2, 77, 30, 7, True), (1, 512, 8, 32, True)]


@pytest.mark.parametrize("b,t,di,n,with_dh", SCAN_CASES)
def test_selective_scan_bwd_ref_matches_jax_vjp(b, t, di, n, with_dh):
    """dx, ddt, dB, dC, da and dh0 against ``jax.vjp`` of the reference's
    model scan (``_ssm_scan``; T = 512 is two of its checkpointed chunks
    of 256)."""
    ins, dy, dh = _scan_inputs(b, t, di, n, t + di, with_dh)
    want = _jax_vjp(ref_mamba._ssm_scan, ins, dy, dh)
    got = ref.selective_scan_bwd_ref(
        *(torch.tensor(a) for a in ins), torch.tensor(dy),
        None if dh is None else torch.tensor(dh))
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "da", "dh0"), got, want):
        assert _err(g, w) <= SCAN_TOL, name


def _autograd(fn, ins, dy, ds):
    """Every input's gradient of ``fn``'s (y, final state) under (dy,
    ds), by torch.autograd."""
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    y, s_t = fn(*leaves)
    loss = (y.float() * torch.tensor(dy)).sum()
    if ds is not None:
        loss = loss + (s_t * torch.tensor(ds)).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("t", [64, 65, 129])
@pytest.mark.parametrize("with_ds", [False, True])
def test_backward_refs_match_autograd_of_the_forward_refs(t, with_ds):
    """Both plain backwards against autograd through the plain forwards
    (``wkv6_ref``, ``selective_scan_ref``) about the kernels' 64-step
    chunks, with the final state's gradient given and not."""
    ins, dy, ds = _wkv_inputs(1, t, 2, t, with_ds)
    want = _autograd(ref.wkv6_ref, ins, dy, ds)
    got = ref.wkv6_bwd_ref(*(torch.tensor(a) for a in ins), torch.tensor(dy),
                           None if ds is None else torch.tensor(ds))
    for g, w in zip(got, want):
        assert _err(g, w.numpy()) <= SCAN_TOL
    ins, dy, dh = _scan_inputs(2, t, 20, 16, t, with_ds)
    want = _autograd(ref.selective_scan_ref, ins, dy, dh)
    got = ref.selective_scan_bwd_ref(
        *(torch.tensor(a) for a in ins), torch.tensor(dy),
        None if dh is None else torch.tensor(dh))
    for g, w in zip(got, want):
        assert _err(g, w.numpy()) <= SCAN_TOL


@pytest.mark.parametrize("op", ["wkv6", "selective_scan"])
def test_autograd_functions_drop_no_gradient(op):
    """``ops.wkv6`` and ``ops.selective_scan`` with every input requiring
    grad, bf16 sequence operands as training gives them: each input gets
    autograd's gradient through the plain forward (y cast to the
    operands' dtype as ``ops`` casts it, the final state's cotangent
    given), within 1e-5 of its scale in fp32 and bit-equal in bf16 (the
    same plain backward rounds once), and a call without grad builds no
    graph."""
    if op == "wkv6":
        ins, dy, ds = _wkv_inputs(2, 70, 2, 0, True)
        fwd, call, n_seq = ref.wkv6_ref, ops.wkv6, 3
    else:
        ins, dy, ds = _scan_inputs(2, 70, 20, 16, 0, True)
        fwd, call, n_seq = ref.selective_scan_ref, ops.selective_scan, 4
    for dtype in (torch.float32, torch.bfloat16):
        def cast(*xs):
            return [x.to(dtype) if i < n_seq else x for i, x in enumerate(xs)]
        leaves = [torch.tensor(a, requires_grad=True) for a in ins]
        y, s_t = call(*cast(*leaves))
        assert y.dtype == dtype and y.grad_fn is not None
        got = torch.autograd.grad(
            (y.float() * torch.tensor(dy)).sum()
            + (s_t * torch.tensor(ds)).sum(), leaves)
        plain = [torch.tensor(a, requires_grad=True) for a in ins]
        py, ps = fwd(*cast(*plain))
        want = torch.autograd.grad(
            (py.to(dtype).float() * torch.tensor(dy)).sum()
            + (ps * torch.tensor(ds)).sum(), plain)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
            assert _err(g, w.numpy()) <= (SCAN_TOL if dtype == torch.float32
                                          else 2 ** -7)
    with torch.no_grad():
        y, _ = call(*(torch.tensor(a, requires_grad=True) for a in ins))
    assert y.grad_fn is None


# --------------------------------------------------------------------------
# the models: train_loss, its gradients and one step
# --------------------------------------------------------------------------

def _pair(arch):
    """(port cfg, reference cfg) at the test's size; the MoE's capacity
    drops nothing (E / k)."""
    kw = dict(layers=2, d_model=128 if arch == "rwkv6-3b" else 64)
    cfg, rcfg = scaled_down(get_arch(arch), **kw), ref_scaled_down(
        ref_get_arch(arch), **kw)
    if cfg.is_moe:
        cf = cfg.num_experts / cfg.experts_per_token
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
    return cfg, rcfg


def _batch(cfg, seed, b=B, s=S):
    """A numpy train batch: tokens, targets, a mask with zeros, and the
    audio family's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32),
           "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in batch.items()}


@contextlib.contextmanager
def _fp32():
    """Both packages' compute dtype fp32 inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_tfm, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
        yield


@pytest.fixture(scope="module")
def family_runs():
    """arch -> the port's and the reference's (loss, metrics, gradients
    in the port's layout) and, from the same parameters, (params before,
    the port's params and metrics after one ``make_train_step`` update,
    the reference's)."""
    out = {}
    for arch in ARCHS:
        cfg, rcfg = _pair(arch)
        conv = CONVERT[arch]
        rp = jax.device_get(R.init_params(jax.random.PRNGKey(1), rcfg))
        batch = _batch(cfg, 3)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        with _fp32():
            fn = jax.jit(jax.value_and_grad(
                functools.partial(ref_tfm.train_loss, rcfg), has_aux=True))
            (loss, metrics), grads = fn(rp, jbatch)
            params = conv(rp)
            leaves = optim.tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            mloss, mmetrics = transformer.train_loss(cfg, params,
                                                     _torch_batch(batch))
            mgrads = torch.autograd.grad(mloss, leaves)
            for p in leaves:
                p.requires_grad_(False)
            shape = dict(seq_len=S, global_batch=B, kind="train")
            rstep = jax.jit(ref_make_train_step(
                rcfg, RefShapeConfig("t", **shape),
                ref_optim.OptConfig(**OPT)))
            rafter, _, rm = rstep(rp, ref_optim.adamw_init(rp), jbatch)
            before = conv(rp)
            step = make_train_step(cfg, ShapeConfig("t", **shape),
                                   optim.OptConfig(**OPT))
            after, _, m = step(conv(rp), optim.adamw_init(before),
                               _torch_batch(batch))
        out[arch] = dict(
            mine=(mloss.detach(),
                  {k: v.detach() for k, v in mmetrics.items()}, mgrads),
            theirs=(float(loss), jax.device_get(metrics),
                    optim.tree_leaves(conv(jax.device_get(grads)))),
            step=(before, after, m, conv(jax.device_get(rafter)),
                  jax.device_get(rm)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(family_runs, arch):
    """fp32: the loss, ce, lb_loss and z_loss within 1e-5 relative, the
    token count equal, every parameter's gradient within 1e-4 of its
    largest magnitude (the MoE's aux losses summed over the layers)."""
    (loss, metrics, grads), (rloss, rmetrics, rgrads) = (
        family_runs[arch]["mine"], family_runs[arch]["theirs"])
    assert _rel(loss, rloss) <= LOSS_TOL
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    for k in ("ce", "loss", "lb_loss", "z_loss"):
        assert _rel(metrics[k], rmetrics[k]) <= LOSS_TOL or (
            float(metrics[k]) == float(rmetrics[k]) == 0.0), k
    if arch.startswith("jamba"):
        assert float(rmetrics["lb_loss"]) > 0 and float(
            rmetrics["z_loss"]) > 0
    assert len(grads) == len(rgrads)
    for g, w in zip(grads, rgrads):
        assert _err(g, w.numpy()) <= GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(family_runs, arch):
    """One ``make_train_step`` update from the same parameters and
    batch, the clip and the decay active: loss, grad_norm, lr and ce
    within 1e-5 relative, and each parameter within 1e-4 of the largest
    element of its update plus the rounding of the two updated values
    (2^-22 of the parameter)."""
    before, after, m, rafter, rm = family_runs[arch]["step"]
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert _rel(m[k], rm[k]) <= LOSS_TOL, k
    assert float(rm["grad_norm"]) > OPT["grad_clip"]    # the clip is active
    for a, w, p0 in zip(optim.tree_leaves(after), optim.tree_leaves(rafter),
                        optim.tree_leaves(before)):
        tol = GRAD_TOL * float((w - p0).abs().max()) + 2 ** -22 * w.abs()
        assert bool(((a - w).abs() <= tol).all())


def test_whisper_encoder_gets_gradients(family_runs):
    """The cross-attention's K/V come from the encoder's output inside
    each decoder layer, so every encoder parameter's gradient is
    nonzero."""
    cfg, _ = _pair("whisper-medium")
    params = CONVERT["whisper-medium"](jax.device_get(R.init_params(
        jax.random.PRNGKey(1), _pair("whisper-medium")[1])))
    leaves = optim.tree_leaves(params)
    grads = family_runs["whisper-medium"]["mine"][2]
    enc = {id(t) for t in optim.tree_leaves(params["encoder"])}
    enc_grads = [g for p, g in zip(leaves, grads) if id(p) in enc]
    assert len(enc_grads) == len(enc) > 0
    assert all(float(g.abs().max()) > 0 for g in enc_grads)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_family(arch):
    """``launch/train.py --arch ARCH --reduced --device cpu --steps 1``:
    the reference's header and step line, then a JSON line with a finite
    loss and no kernel launch (the CPU runs the plain versions)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                               "--steps", "1", "--batch", "2", "--seq",
                               "16"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith(f"[train] {arch}: ")
    assert lines[0].endswith("M params (reduced)")
    assert lines[1].startswith("[train] step     0 loss ")
    stats = json.loads(lines[-1])
    assert stats["arch"] == arch and stats["device"] == "cpu"
    assert len(stats["loss"]) == 1 and np.isfinite(stats["loss"][0])
    assert stats["launches"] == {}
