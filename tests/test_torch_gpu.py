"""The hand-written CUDA kernels against their plain versions, on the
card.  Every test here needs a CUDA card and skips without one.  The
file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.mnist_cnn import CONFIG
from repro_torch.core import elect
from repro_torch.core.fuzzy import FuzzyEvaluatorConfig, default_level_centers
from repro_torch.core.rules import build_rule_table
from repro_torch.kernels import build, ops, ref
from repro_torch.models.cnn import init_cnn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mamdani(device):
    cfg = FuzzyEvaluatorConfig()
    return (torch.tensor(cfg.means, device=device),
            torch.tensor(cfg.sigmas, device=device),
            default_level_centers(device))


def _probe_inputs(device, counts=(24, 7, 40, 13, 1, 30)):
    rng = np.random.default_rng(0)
    counts = np.asarray(counts)
    n, s = len(counts), int(counts.sum())
    seg = np.repeat(np.arange(n), counts).astype(np.int32)
    seg[::11] = n                                 # overflow-lane rows
    t = lambda a: torch.tensor(a, device=device)
    return dict(
        params=init_cnn(torch.Generator().manual_seed(0), CONFIG, device),
        images=t(rng.normal(size=(s, 28, 28, 1)).astype(np.float32)),
        labels=t(rng.integers(0, 10, s).astype(np.int32)), seg=t(seg),
        counts=t(np.bincount(seg, minlength=n + 1)[:n].astype(np.int32)),
        aux=t((np.abs(rng.normal(size=(n, 3))) * [100., 1e6, 1.])
              .astype(np.float32)), n=n)


def _probe(fx, device, col_maxima=None):
    table, levels = build_rule_table()
    mv = lambda v: v.to(device) if torch.is_tensor(v) else v
    params = {k: v.to(device) for k, v in fx["params"].items()}
    return ops.probe_fuzzy(
        params, *(mv(fx[k]) for k in ("images", "labels", "seg", "counts",
                                      "aux")),
        *_mamdani(device)[:2], table, levels, _mamdani(device)[2],
        n_clients=fx["n"],
        col_maxima=None if col_maxima is None else col_maxima.to(device))


def test_probe_fuzzy_kernel_matches_plain(cuda):
    """Losses 1e-4 relative, evals 1e-3 on [0, 100]: fp32 sums in
    another order (conv and GEMM tiling, per-client sums)."""
    fx = _probe_inputs(cuda)
    for cm in (None, torch.tensor([150., 3e6, 2.5, 4.0])):
        before = build.LAUNCHES["probe_fuzzy"]
        f, e = _probe(fx, cuda, cm)
        assert build.LAUNCHES["probe_fuzzy"] == before + 1
        f0, e0 = _probe(fx, "cpu", cm)
        np.testing.assert_allclose(f.cpu().numpy(), f0.numpy(), rtol=1e-4)
        np.testing.assert_allclose(e.cpu().numpy(), e0.numpy(), rtol=0,
                                   atol=1e-3)


def test_probe_fuzzy_kernel_is_run_to_run_bit_identical(cuda):
    fx = _probe_inputs(cuda, counts=(300, 200, 1, 500))
    a, b = _probe(fx, cuda), _probe(fx, cuda)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("p", [30, 70_000])
def test_fuzzy_eval_kernel_matches_plain(cuda, normalize, p):
    x = torch.rand(p, 4, generator=torch.Generator().manual_seed(0))
    if normalize:
        x = x * torch.tensor([4500., 3e6, 1., 3.])
    table, levels = build_rule_table()
    want = ops.fuzzy_eval(x, *_mamdani("cpu")[:2], table, levels,
                          _mamdani("cpu")[2], normalize=normalize)
    m = _mamdani(cuda)
    got = ops.fuzzy_eval(x.to(cuda), m[0], m[1], table, levels, m[2],
                         normalize=normalize)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("n", [30, 257, 4096])
def test_neighbor_elect_kernel_bit_equal(cuda, n):
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 1000 * max(1, n // 30), n).astype(np.float32)
    ev = rng.uniform(0, 100, n).astype(np.float32)
    pos[:6] = [100, 300, 300, 500, 700, 900]       # d == comm_range
    ev[:6] = [50, 50, 50, 30, 30, 29.999]           # ties, E_tau
    ev[6:12] = 50.0
    kw = dict(comm_range=200.0, top_m=2, e_tau=30.0)
    want = ref.neighbor_elect_ref(torch.tensor(pos), torch.tensor(ev), **kw)
    got = ops.neighbor_elect(torch.tensor(pos, device=cuda),
                             torch.tensor(ev, device=cuda), **kw)
    assert torch.equal(got.cpu(), want)


def _sorted_fleet(n, seed, road, device):
    """A fleet sorted by position and padded as ``sorted_window_counts``
    pads it, with pairs exactly ``comm_range`` apart, duplicate
    positions and tied evaluations."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, road, n).astype(np.float32)
    ev = rng.uniform(0, 100, n).astype(np.float32)
    pos[:6] = [100, 300, 300, 500, 700, 900]
    ev[:6] = [50, 50, 50, 30, 30, 29.999]
    ev[6:40] = 50.0
    order = np.argsort(pos, kind="stable")
    block = min(128, max(32, n))
    pad = -(-n // block) * block - n
    def t(parts, dtype):
        return torch.tensor(np.concatenate(parts).astype(dtype),
                            device=device)
    return (t([pos[order], np.full(pad, elect.SENT_POS)], np.float32),
            t([ev[order], np.full(pad, elect.SENT_EV)], np.float32),
            t([order, np.full(pad, n)], np.int32), block)


@pytest.mark.parametrize("window", [1, 100, 616])
@pytest.mark.parametrize("n", [100, 129, 4096, 65536])
def test_windowed_counts_kernel_bit_equal(cuda, n, window):
    sp, se, sg, block = _sorted_fleet(n, n, float(n), cuda)
    kw = dict(comm_range=200.0, e_tau=30.0, n_valid=n, window=window,
              block=block)
    before = build.LAUNCHES["windowed_counts"]
    got = ops.windowed_counts(sp, se, sg, **kw)
    assert build.LAUNCHES["windowed_counts"] == before + 1
    want = ref.windowed_counts_ref(sp, se, sg, **kw)
    assert torch.equal(got, want)
    assert torch.equal(ops.windowed_counts(sp, se, sg, **kw), got)


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_windowed_election_equals_dense_kernel_unless_flagged(cuda, kind):
    n = 4096
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, n, n).astype(np.float32)
    if kind == "clustered":
        pos[: n // 2] = rng.uniform(0, 150, n // 2)
    ev = rng.uniform(0, 100, n).astype(np.float32)
    tp, te = torch.tensor(pos, device=cuda), torch.tensor(ev, device=cuda)
    kw = dict(comm_range=200.0, top_m=2, e_tau=30.0)
    dense = ops.neighbor_elect(tp, te, **kw)
    flags = []
    for window in (16, elect.auto_window(n, 200.0, float(n))):
        mask, ovf = ops.neighbor_elect_windowed(tp, te, window=window, **kw)
        _, oracle = ref.windowed_elect_ref(tp, te, window=window, **kw)
        assert int(ovf) >= int(oracle)
        if int(ovf) == 0:
            assert torch.equal(mask, dense)
        flags.append(int(ovf))
    assert flags == ([1, 0] if kind == "uniform" else [1, 1])
