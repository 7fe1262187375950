"""The port's CNN against the JAX reference through ``convert.py``."""
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
# ``models/cnn.py`` hands them to ``cohort_gemm``: (R, K, M, N, Z1) and
# the runs ``gemm_splits`` cuts each output's sum into
SGD_PRODUCTS = {
    "conv1 forward": ((1, 25, 32, 784, 20), 1),
    "conv2 forward": ((1, 800, 64, 196, 20), 1),
    "conv2 input gradient": ((1, 64, 800, 196, 20), 1),
    "conv1 weight gradient": ((20, 784, 32, 25, 1), 64),
    "conv2 weight gradient": ((20, 196, 64, 800, 1), 5),
    "conv2 bias gradient": ((20, 196, 64, 1, 1), 64),
    "fc1 forward": ((1, 3136, 20, 512, 1), 8),
    "fc1 input gradient": ((1, 512, 20, 3136, 1), 2),
    "fc1 weight gradient": ((1, 20, 512, 3136, 1), 1),
}


@pytest.mark.parametrize("product", sorted(SGD_PRODUCTS))
def test_cohort_gemm_splits_are_a_clients_own(product):
    """``gemm_splits``: the long sums of one client's product (fc1's
    forward, the convolutions' weight and bias gradients) are cut into
    enough runs of k steps to give the client ~64 CTAs, the wide
    products stay one run, and the kernel's cut of the R x ceil(K / 16)
    steps into runs covers each step once with at least 4 a run.  The
    count takes no cohort size, so a client's sums keep their order
    however many clients share the launch."""
    from repro_torch.kernels.cohort_gemm import (SPLIT_MIN_STEPS, TILE_K,
                                                 gemm_splits)
    (r, k, m, n, z1), want = SGD_PRODUCTS[product]
    splits = gemm_splits(r, k, m, n, z1)
    assert splits == want
    steps = r * -(-k // TILE_K)
    runs = [(steps * s // splits, steps * (s + 1) // splits)
            for s in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert splits == 1 or min(t1 - t0 for t0, t1 in runs) >= SPLIT_MIN_STEPS
