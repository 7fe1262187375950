"""The port's CNN against the JAX reference through ``convert.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as REF_CFG
from repro.models.cnn import cnn_forward as ref_forward
from repro.models.cnn import cnn_sample_losses as ref_losses
from repro.models.cnn import init_cnn as ref_init
from repro_torch.configs.mnist_cnn import CONFIG
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models.cnn import (_stacked_conv_gemm, cnn_forward,
                                    cnn_forward_stacked, cnn_sample_losses,
                                    count_params, init_cnn)
from torch_threads import torch_intra_op_threads  # noqa: F401


def _ref_params(seed=0):
    return jax.device_get(ref_init(jax.random.PRNGKey(seed), REF_CFG))


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 28, 28, 1)).astype(np.float32), \
        rng.integers(0, 10, n).astype(np.int32)


def test_converter_round_trips_exactly():
    ref = _ref_params()
    back = params_to_numpy(params_from_jax(ref))
    for name in ref:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[name][leaf],
                                          np.asarray(ref[name][leaf]))
    port = init_cnn(torch.Generator().manual_seed(1), CONFIG)
    again = params_from_jax(params_to_numpy(port))
    for k, v in port.items():
        assert torch.equal(again[k], v)
    assert count_params(port) == 1_663_370


def test_forward_logits_and_losses_match_reference():
    """fp32 convolutions of XLA:CPU and oneDNN sum in different orders:
    logits agree to 1e-4 relative."""
    ref = _ref_params(3)
    params = params_from_jax(ref)
    im, lb = _images(16)
    got = cnn_forward(params, torch.tensor(im)).detach().numpy()
    want = np.asarray(ref_forward(ref, jnp.asarray(im)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got = cnn_sample_losses(params, torch.tensor(im),
                            torch.tensor(lb)).detach().numpy()
    want = np.asarray(ref_losses(ref, jnp.asarray(im), jnp.asarray(lb)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_fc1_rows_follow_nhwc_flatten():
    """A weight on one fc1 row must read the NHWC-flatten feature of the
    reference: zero every row but one and compare the logits."""
    ref = _ref_params(4)
    row = (1 * 7 + 0) * 64 + 5            # (h=1, w=0, c=5)
    ref["fc1"]["w"] = np.zeros_like(ref["fc1"]["w"])
    ref["fc1"]["w"][row] = 1.0
    ref["fc1"]["b"] = np.zeros_like(ref["fc1"]["b"])
    im, _ = _images(4, 1)
    got = cnn_forward(params_from_jax(ref), torch.tensor(im)).detach()
    want = np.asarray(ref_forward(ref, jnp.asarray(im)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_stacked_forward_equals_per_model_forward():
    ps = [init_cnn(torch.Generator().manual_seed(s), CONFIG)
          for s in range(3)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    im, _ = _images(15, 2)
    x = torch.tensor(im).reshape(3, 5, 28, 28, 1)
    got = cnn_forward_stacked(stacked, x).detach()
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(),
                                   cnn_forward(ps[c], x[c]).detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clients,in_ch,out_ch", [(1, 1, 32), (4, 1, 32),
                                                  (3, 32, 64)])
def test_card_conv_form_equals_grouped_conv(clients, in_ch, out_ch):
    """The stacked forward's convolution on the card, patches times
    weights, against the grouped convolution the CPU runs: values and
    all three gradients in fp64 (to 1e-12), the two summing in other
    orders."""
    g = torch.Generator().manual_seed(clients)
    x = torch.randn(5, clients * in_ch, 14, 14, generator=g,
                    dtype=torch.float64, requires_grad=True)
    w = torch.randn(clients, out_ch, in_ch, 5, 5, generator=g,
                    dtype=torch.float64, requires_grad=True)
    b = torch.randn(clients, out_ch, generator=g, dtype=torch.float64,
                    requires_grad=True)
    want = torch.nn.functional.conv2d(
        x, w.reshape(-1, in_ch, 5, 5), b.reshape(-1), padding=2,
        groups=clients)
    got = _stacked_conv_gemm(x, w, b)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-12)
    up = torch.randn(want.shape, generator=g, dtype=torch.float64)
    for gw, gg in zip(torch.autograd.grad((want * up).sum(), [x, w, b]),
                      torch.autograd.grad((got * up).sum(), [x, w, b])):
        np.testing.assert_allclose(gg.numpy(), gw.numpy(), rtol=0,
                                   atol=1e-12 * float(gw.abs().max()))


# the fast profile's local-SGD products at 20 samples a step, as
# ``models/cnn.py`` hands them to ``cohort_gemm`` (the four weight
# gradients carry their bias gradients as row sums): (R, K, M, N, Z1),
# whether Z1 joins N (``gemm_fold``: the weights broadcast over the
# batch) and the fp32 kernel's tile, runs, ring and chunk (``gemm_plan``)
SGD_PRODUCTS = {
    "conv1 forward": ((1, 25, 32, 784, 20), True, (32, 64, 1, 2, 32)),
    "conv2 forward": ((1, 800, 64, 196, 20), True, (64, 64, 5, 4, 32)),
    "conv2 input gradient": ((1, 64, 800, 196, 20), True,
                             (64, 64, 1, 2, 32)),
    "conv1 weight gradient": ((20, 784, 32, 25, 1), False,
                              (32, 32, 16, 4, 64)),
    "conv2 weight gradient": ((20, 196, 64, 800, 1), False,
                              (64, 64, 16, 4, 32)),
    "fc1 forward": ((1, 3136, 20, 512, 1), False, (32, 64, 8, 4, 32)),
    "fc1 input gradient": ((1, 512, 20, 3136, 1), False, (32, 64, 4, 4, 32)),
    "fc1 weight gradient": ((1, 20, 512, 3136, 1), False,
                            (64, 64, 1, 2, 32)),
    "fc2 forward": ((1, 512, 20, 10, 1), False, (32, 32, 4, 4, 64)),
    "fc2 input gradient": ((1, 10, 20, 512, 1), False, (32, 64, 1, 2, 32)),
    "fc2 weight gradient": ((1, 20, 10, 512, 1), False, (16, 64, 1, 2, 32)),
}


@pytest.mark.parametrize("product", sorted(SGD_PRODUCTS))
def test_cohort_gemm_splits_are_a_clients_own(product):
    """``gemm_plan``: the tile follows the product's M and N (Z1 N where
    the weights broadcast over the batch), the long sums of one client's
    product (fc1's forward and input gradient, the forward of conv2, the
    convolutions' weight gradients) are cut into runs of k chunks, a
    cluster of up to 8 CTAs (16 for the weight gradients' sums, longer
    than 8 runs of 16 chunks), to give the client ~256 CTAs, the wide
    products stay one run, and the kernel's cut of the R x ceil(K / 32)
    chunks into runs covers each chunk once with at least 4 a run.  The
    plan takes no cohort size, so a client's sums keep their order
    however many clients share the launch; ``gemm_fold`` decides on the
    views of the step's own call (a cohort of 3 and a member alone)."""
    import inspect
    from repro_torch.kernels.cohort_gemm import (LONG_RUN, MAX_SPLITS,
                                                 PORTABLE_SPLITS,
                                                 SPLIT_MIN_STEPS, TILE_K,
                                                 gemm_fold, gemm_plan)
    assert list(inspect.signature(gemm_plan).parameters) == [
        "r", "k", "m", "n", "z1", "fold"]
    (r, k, m, n, z1), fold, want = SGD_PRODUCTS[product]
    bm, bn, splits, stages, bk = gemm_plan(r, k, m, n, z1, fold)
    assert (bm, bn, splits, stages, bk) == want
    assert bm >= min(m, 64) and bm in (16, 32, 64) and bn in (32, 64)
    steps = r * -(-k // bk)                  # the kernel's chunks
    runs = [(steps * s // splits, steps * (s + 1) // splits)
            for s in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert splits == 1 or min(t1 - t0 for t0, t1 in runs) >= (
        SPLIT_MIN_STEPS * TILE_K // bk)
    assert 1 <= splits <= MAX_SPLITS
    assert splits <= PORTABLE_SPLITS or (
        r * -(-k // TILE_K) > PORTABLE_SPLITS * LONG_RUN)
    assert (stages == 2) == (bk == TILE_K and max(
        t1 - t0 for t0, t1 in runs) <= 2)
    calls = {c: {lab: (a, b, rs) for lab, a, b, _, rs in
                 _step_calls(c)} for c in (1, 3)}
    for c in (1, 3):
        a, b, rs = calls[c][product]
        assert gemm_fold(a, b, rs) == fold
        assert gemm_fold(a[:, -1:], b[:, -1:], rs) == fold


# a step's calls by product: (R, K, M, N, Z1) and whether they carry row
# sums -> the names above
_NAMES = {dims: name for name, (dims, _, _) in SGD_PRODUCTS.items()}


@functools.lru_cache(maxsize=None)
def _step_calls(c: int) -> list:
    """Every ``cohort_gemm`` call of one local-SGD step of ``c`` clients
    at the fast profile's widths: [(name, a, b, bias, rowsum)]."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(c)
    p = {k: v[None].expand(c, *v.shape).clone().requires_grad_(True)
         for k, v in init_cnn(g, CONFIG).items()}
    images = torch.randn(c, 20, 28, 28, 1, generator=g)
    labels = torch.randint(0, 10, (c, 20), generator=g)
    calls, kernel = [], ops.cohort_gemm

    def record(a, b, bias=None, rowsum=False):
        z1, _, r, m, k = a.shape
        calls.append((_NAMES[(r, k, m, b.shape[4], z1)], a, b, bias,
                      rowsum))
        return kernel(a, b, bias, rowsum)
    ops.cohort_gemm = record
    try:
        logits = cnn_forward_stacked(p, images)
        loss = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[..., None])[..., 0]
        torch.autograd.grad(loss.sum(), list(p.values()))
    finally:
        ops.cohort_gemm = kernel
    return calls


# the fp64 kernel's runs of 16-wide k steps (``gemm_splits_f64``), at the
# same products
F64_SPLITS = {
    "conv1 forward": 1, "conv2 forward": 1, "conv2 input gradient": 1,
    "conv1 weight gradient": 64, "conv2 weight gradient": 5,
    "fc1 forward": 8, "fc1 input gradient": 2, "fc1 weight gradient": 1,
    "fc2 forward": 8, "fc2 input gradient": 1, "fc2 weight gradient": 1,
}


@pytest.mark.parametrize("product", sorted(F64_SPLITS))
def test_cohort_gemm_f64_splits_are_a_clients_own(product):
    """``gemm_splits_f64``, the fp64 CUDA-core tile's runs: enough for
    ~64 CTAs a client with at least 4 steps a run, from the product's
    own sizes only."""
    from repro_torch.kernels.cohort_gemm import gemm_splits_f64
    (r, k, m, n, z1), _, _ = SGD_PRODUCTS[product]
    assert gemm_splits_f64(r, k, m, n, z1) == F64_SPLITS[product]
