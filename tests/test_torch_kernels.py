"""The port's kernel modules against the JAX reference's kernels.

On the CPU the port's ops run their plain PyTorch versions; they are
held against the reference's Pallas kernels in interpret mode and its
naive oracles on the same seeded inputs.  The CUDA kernels are held
against these plain versions on the card in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as REF_CFG
from repro.core.fuzzy import FuzzyEvaluator
from repro.core.rules import build_rule_table as ref_rules
from repro.kernels import ops as ref_ops
from repro.kernels.fuzzy_eval import fuzzy_eval_pallas
from repro.kernels.neighbor_elect import neighbor_elect_pallas
from repro.models.cnn import init_cnn as ref_init
from repro_torch.convert import params_from_jax
from repro_torch.core.rules import build_rule_table
from repro_torch.kernels import build, ops
from torch_threads import torch_intra_op_threads  # noqa: F401


def _mamdani_np():
    ev = FuzzyEvaluator()
    return (np.asarray(ev.cfg.means, np.float32),
            np.asarray(ev.cfg.sigmas, np.float32),
            np.asarray(ev.level_centers, np.float32))


def _packed_fixture():
    """The reference's own fixture (tests/test_probe_fuzzy.py): six
    clients with ragged probe counts, one with a single sample."""
    rng = np.random.default_rng(0)
    n = 6
    counts = np.array([24, 7, 40, 13, 1, 30])
    s = int(counts.sum())
    means, sigmas, centers = _mamdani_np()
    aux = (np.abs(rng.normal(size=(n, 3))).astype(np.float32)
           * np.array([100., 1e6, 1.], np.float32))
    return dict(
        n=n,
        images=rng.normal(size=(s, 28, 28, 1)).astype(np.float32),
        labels=rng.integers(0, 10, s).astype(np.int32),
        seg=np.repeat(np.arange(n), counts).astype(np.int32),
        counts=counts.astype(np.int32), aux=aux.astype(np.float32),
        params=jax.device_get(ref_init(jax.random.PRNGKey(0), REF_CFG)),
        means=means, sigmas=sigmas, centers=centers)


def _ref_probe(fx, impl, col_maxima=None):
    table, levels = ref_rules()
    return ref_ops.probe_fuzzy(
        fx["params"], jnp.asarray(fx["images"]), jnp.asarray(fx["labels"]),
        jnp.asarray(fx["seg"]), jnp.asarray(fx["counts"]),
        jnp.asarray(fx["aux"]), jnp.asarray(fx["means"]),
        jnp.asarray(fx["sigmas"]), table, levels,
        jnp.asarray(fx["centers"]), n_clients=fx["n"], batch=32, impl=impl,
        col_maxima=None if col_maxima is None else jnp.asarray(col_maxima))


def _port_probe(fx, device="cpu", col_maxima=None):
    table, levels = build_rule_table()
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    return ops.probe_fuzzy(
        params_from_jax(fx["params"], device=device), t(fx["images"]),
        t(fx["labels"]), t(fx["seg"]), t(fx["counts"]), t(fx["aux"]),
        t(fx["means"]), t(fx["sigmas"]), table, levels, t(fx["centers"]),
        n_clients=fx["n"],
        col_maxima=None if col_maxima is None else t(col_maxima))


@pytest.mark.parametrize("impl", ["pallas", "oracle"])
@pytest.mark.parametrize("external", [False, True])
def test_probe_fuzzy_plain_matches_reference(impl, external):
    """Per-client losses to 1e-5 relative (fp32 convolutions summed in
    another order by oneDNN and XLA); evaluations to 1e-3 on the
    [0, 100] scale."""
    fx = _packed_fixture()
    cm = None
    if external:
        cm = np.asarray(_ref_probe(fx, "oracle")[0]).max(axis=0) * 1.5
    f_ref, e_ref = _ref_probe(fx, impl, cm)
    launches = dict(build.LAUNCHES)
    f, e = _port_probe(fx, col_maxima=cm)
    assert build.LAUNCHES == launches        # CPU tensors: plain version
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_fuzzy_eval_plain_matches_pallas(normalize):
    """Evaluations to 1e-4 on [0, 100]: the Pallas kernel normalizes by a
    reciprocal multiply, the plain version divides (one ulp apart)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (300, 4)).astype(np.float32)
    if normalize:
        x = x * np.array([4500, 3e6, 1.0, 2.5], np.float32)
    x[:3] = [[0, 0, 0, 0], [1, 1, 1, 1], [0.5, 0.15, 0.85, 1.0]] \
        if not normalize else x[:3]
    means, sigmas, centers = _mamdani_np()
    table, levels = ref_rules()
    want = fuzzy_eval_pallas(jnp.asarray(x), jnp.asarray(means),
                             jnp.asarray(sigmas), table, levels,
                             jnp.asarray(centers), interpret=True,
                             normalize=normalize)
    got = ops.fuzzy_eval(torch.tensor(x), torch.tensor(means),
                         torch.tensor(sigmas), *build_rule_table(),
                         torch.tensor(centers), normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _elect_inputs(n, seed):
    """Positions on a 1 km road with forced exact ties and pairs exactly
    ``comm_range`` apart (integers and halves are exact in fp32)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1000, n).astype(np.float32)
    ev = rng.uniform(0, 100, n).astype(np.float32)
    pos[:8] = [100, 300, 300, 500, 100.5, 300.5, 700, 900]   # d == 200
    ev[:8] = [50, 50, 50, 29.999, 30, 30, 80, 80]            # ties, E_tau
    ev[8:12] = ev[0]
    return pos, ev


@pytest.mark.parametrize("n,seed", [(30, 0), (97, 1), (300, 2)])
def test_neighbor_elect_plain_bit_equal_to_pallas(n, seed):
    pos, ev = _elect_inputs(n, seed)
    for top_m in (1, 2, 3):
        want = neighbor_elect_pallas(jnp.asarray(pos), jnp.asarray(ev),
                                     comm_range=200.0, top_m=top_m,
                                     e_tau=30.0, interpret=True)
        got = ops.neighbor_elect(torch.tensor(pos), torch.tensor(ev),
                                 comm_range=200.0, top_m=top_m, e_tau=30.0)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_neighbor_elect_fp32_threshold_at_comm_range_edge():
    """A distance that exceeds 0.1 in float64 but equals fp32(0.1) is in
    range: comparisons are fp32, as in JAX."""
    pos = np.array([0.0, np.float32(0.1)], np.float32)
    ev = np.array([50.0, 60.0], np.float32)
    want = neighbor_elect_pallas(jnp.asarray(pos), jnp.asarray(ev),
                                 comm_range=0.1, top_m=1, e_tau=30.0,
                                 interpret=True)
    got = ops.neighbor_elect(torch.tensor(pos), torch.tensor(ev),
                             comm_range=0.1, top_m=1, e_tau=30.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 1]


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.neighbor_elect import neighbor_elect_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        neighbor_elect_cuda(torch.zeros(4), torch.zeros(4), comm_range=1.0,
                            top_m=1, e_tau=0.0)
