"""The port's CNN against the JAX reference through ``convert.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.mnist_cnn import CONFIG as REF_CFG
from repro.models.cnn import cnn_forward as ref_forward
from repro.models.cnn import cnn_sample_losses as ref_losses
from repro.models.cnn import init_cnn as ref_init
from repro_torch.configs.mnist_cnn import CONFIG
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models.cnn import (cnn_forward, cnn_forward_stacked,
                                    cnn_sample_losses, count_params,
                                    init_cnn)


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
