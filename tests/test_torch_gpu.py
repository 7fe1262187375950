"""The hand-written CUDA kernels against their plain versions, on the
card.  Every test here needs a CUDA card and skips without one.  The
file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, scaled_down
from repro_torch.configs.mnist_cnn import CONFIG
from repro_torch.core import elect
from repro_torch.core.fuzzy import FuzzyEvaluatorConfig, default_level_centers
from repro_torch.core.rules import build_rule_table
from repro_torch.kernels import build, ops, ref
from repro_torch.models import registry
from repro_torch.models.cnn import init_cnn
from repro_torch.serve import engine

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


def _probe_inputs(device, counts=(24, 7, 40, 13, 1, 30), seed=0):
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    n, s = len(counts), int(counts.sum())
    seg = np.repeat(np.arange(n), counts).astype(np.int32)
    seg[::11] = n                                 # overflow-lane rows
    t = lambda a: torch.tensor(a, device=device)
    return dict(
        params=init_cnn(torch.Generator().manual_seed(seed), CONFIG,
                        device),
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


def _probe_seeds(device, n_seeds=3, counts=(300, 45, 1, 45, 130)):
    """``n_seeds`` packs of one shape with their own weights, images and
    aux, stacked on ``device`` as the sweep's seed-batched prefix stacks
    them, and each seed's own inputs."""
    one = [_probe_inputs(device, counts=counts, seed=i)
           for i in range(n_seeds)]
    stack = {k: torch.stack([fx[k] for fx in one]).to(device)
             for k in ("images", "labels", "seg", "counts", "aux")}
    stack["params"] = {k: torch.stack([fx["params"][k] for fx in one])
                       for k in one[0]["params"]}
    return stack, one


def _probe_seeds_call(stack, n, device):
    table, levels = build_rule_table()
    means, sigmas, centers = _mamdani(device)
    return ops.probe_fuzzy(
        stack["params"], *(stack[k] for k in ("images", "labels", "seg",
                                              "counts", "aux")),
        means, sigmas, table, levels, centers, n_clients=n)


def test_probe_fuzzy_seeds_kernel_bit_equal_to_single_launches(cuda):
    """One launch for 3 seeds: each seed's feats and evals bit-equal to
    a launch of that seed alone, within the single kernel's tolerances
    of the plain seed version (feats 1e-4 relative, evals 1e-3 on
    [0, 100]), bit-repeatable, counted once."""
    stack, one = _probe_seeds(cuda)
    n = one[0]["n"]
    before = build.LAUNCHES["probe_fuzzy"]
    f, e = _probe_seeds_call(stack, n, cuda)
    assert build.LAUNCHES["probe_fuzzy"] == before + 1
    f2, e2 = _probe_seeds_call(stack, n, cuda)
    assert torch.equal(f, f2) and torch.equal(e, e2)
    for i, fx in enumerate(one):
        fi, ei = _probe(fx, cuda)
        assert torch.equal(f[i], fi) and torch.equal(e[i], ei), i
    cpu = {k: (v.cpu() if torch.is_tensor(v)
               else {kk: vv.cpu() for kk, vv in v.items()})
           for k, v in stack.items()}
    f0, e0 = _probe_seeds_call(cpu, n, "cpu")
    np.testing.assert_allclose(f.cpu().numpy(), f0.numpy(), rtol=1e-4)
    np.testing.assert_allclose(e.cpu().numpy(), e0.numpy(), rtol=0,
                               atol=1e-3)


def test_probe_fuzzy_seeds_kernel_scales_each_seed_by_its_own_maxima(cuda):
    """Eq. 8 per seed, never over the union of seeds: seed 1's aux times
    1024 (a power of 2, which Eq. 8 undoes exactly) moves no eval bit
    of any seed, though it holds the union's maxima."""
    stack, one = _probe_seeds(cuda)
    n = one[0]["n"]
    _, e = _probe_seeds_call(stack, n, cuda)
    stack["aux"] = stack["aux"].clone()
    stack["aux"][1] *= 1024.0
    f_s, e_s = _probe_seeds_call(stack, n, cuda)
    assert torch.equal(e_s, e)
    assert torch.equal(f_s[1, :, :3], stack["aux"][1])


def _probe_loss(fx, device, **over):
    fx = dict(fx, **over)
    params = {k: v.to(device) for k, v in fx["params"].items()}
    return ops.probe_loss(params, *(fx[k].to(device) for k in (
        "images", "labels", "seg", "counts")), n_clients=fx["n"])


@pytest.mark.parametrize("counts", [(24, 7, 40, 13, 1, 30),
                                    (300, 0, 1, 500, 77)])
def test_probe_loss_kernel_matches_plain(cuda, counts):
    """(N,) Eq. 7 means within 1e-5 of their largest magnitude: fp32
    sums in another order (conv and GEMM tiling, per-client sums); a
    client with no row gets 0; bit-repeatable."""
    fx = _probe_inputs(cuda, counts=counts)
    before = build.LAUNCHES["probe_loss"]
    got, again = _probe_loss(fx, cuda), _probe_loss(fx, cuda)
    assert build.LAUNCHES["probe_loss"] == before + 2
    want = _probe_loss(fx, "cpu")
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err
    assert torch.equal(got, again)
    assert (got.cpu()[torch.tensor(counts) == 0] == 0).all()


def test_probe_loss_lf_is_probe_fuzzy_lf_bit_for_bit(cuda):
    """The two kernels share phases 0-4 and the Eq. 7 mean's arithmetic:
    the probe alone gives the fused kernel's LF column bit for bit."""
    fx = _probe_inputs(cuda, counts=(300, 200, 1, 500, 64))
    assert torch.equal(_probe_loss(fx, cuda), _probe(fx, cuda)[0][:, 3])


def test_probe_loss_is_offset_invariant(cuda):
    """A client's sum depends on its own rows alone: the same pack behind
    37 padding rows (a shard region's offset), or with another client's
    rows in front, gives the same LF bits."""
    fx = _probe_inputs(cuda, counts=(300, 45, 1, 45, 130))
    n = fx["n"]
    base = _probe_loss(fx, cuda)
    lead = 37
    shifted = _probe_loss(fx, cuda, **{
        "images": torch.cat([torch.zeros(lead, 28, 28, 1, device=cuda),
                             fx["images"]]),
        "labels": torch.cat([torch.zeros(lead, dtype=torch.int32,
                                         device=cuda), fx["labels"]]),
        "seg": torch.cat([torch.full((lead,), n, dtype=torch.int32,
                                     device=cuda), fx["seg"]])})
    assert torch.equal(base, shifted)
    # client 0's span of rows (its padding rows with it) moved behind
    # client 4's: every client keeps its rows' layout, and its bits
    seg = fx["seg"]
    span = int(torch.nonzero(seg == 0).max()) + 1
    perm = torch.cat([torch.arange(span, seg.shape[0]),
                      torch.arange(span)]).to(cuda)
    moved = _probe_loss(fx, cuda, images=fx["images"][perm],
                        labels=fx["labels"][perm], seg=seg[perm])
    assert torch.equal(base, moved)


def test_probe_loss_ragged_pack_and_client_across_tiles(cuda):
    """S = 1001, a multiple of neither the conv kernel's 2 samples a
    block nor fc1's 128-row tile, and client 2's 260 rows straddling fc1
    tiles and many conv blocks: within 1e-5 of scale of the plain
    version, bit-repeatable, the fused kernel's LF bit for bit, and the
    same bits one row later (every sample in another slot of its block
    and tile)."""
    fx = _probe_inputs(cuda, counts=(127, 3, 260, 1, 99, 400, 111))
    assert fx["images"].shape[0] == 1001
    n = fx["n"]
    got, again = _probe_loss(fx, cuda), _probe_loss(fx, cuda)
    want = _probe_loss(fx, "cpu")
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(got, again)
    assert torch.equal(got, _probe(fx, cuda)[0][:, 3])
    shifted = _probe_loss(fx, cuda, **{
        "images": torch.cat([torch.zeros(1, 28, 28, 1, device=cuda),
                             fx["images"]]),
        "labels": torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                             fx["labels"]]),
        "seg": torch.cat([torch.full((1,), n, dtype=torch.int32,
                                     device=cuda), fx["seg"]])})
    assert torch.equal(got, shifted)


def test_probe_loss_kernel_refuses_what_it_was_not_built_for(cuda):
    from repro_torch.kernels.probe_loss import probe_loss_cuda
    fx = _probe_inputs(cuda)
    params = {k: v.to(cuda) for k, v in fx["params"].items()}
    ok = {k: fx[k] for k in ("images", "labels", "seg", "counts")}
    bad = [dict(images=fx["images"].double()),
           dict(labels=fx["labels"].long()),
           dict(seg=fx["seg"][:-1]),
           dict(counts=fx["counts"][:-1]),
           dict(images=fx["images"].cpu()),
           dict(images=fx["images"][:, :27])]
    for over in bad:
        args = dict(ok, **over)
        with pytest.raises(ValueError):
            probe_loss_cuda(params, args["images"], args["labels"],
                            args["seg"], args["counts"], n_clients=fx["n"])
    with pytest.raises(ValueError):
        probe_loss_cuda(dict(params, **{"fc1.w": params["fc1.w"][:, :-1]}),
                        *ok.values(), n_clients=fx["n"])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("p", [30, 4096, 70_000, 3_090_000])
def test_fuzzy_eval_kernel_matches_plain(cuda, normalize, p):
    """One launch a call (a cooperative grid past one CTA with
    normalize), within 1e-4 of the plain version on [0, 100] and bit
    for bit from call to call."""
    x = torch.rand(p, 4, generator=torch.Generator().manual_seed(0))
    if normalize:
        x = x * torch.tensor([4500., 3e6, 1., 3.])
    table, levels = build_rule_table()
    want = ops.fuzzy_eval(x, *_mamdani("cpu")[:2], table, levels,
                          _mamdani("cpu")[2], normalize=normalize)
    m = _mamdani(cuda)
    before = build.LAUNCHES["fuzzy_eval"]
    got = ops.fuzzy_eval(x.to(cuda), m[0], m[1], table, levels, m[2],
                         normalize=normalize)
    assert build.LAUNCHES["fuzzy_eval"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
    assert torch.equal(ops.fuzzy_eval(x.to(cuda), m[0], m[1], table,
                                      levels, m[2], normalize=normalize),
                       got)


def test_fuzzy_eval_caches_each_rule_tables_packing_apart(cuda):
    """Two rule bases in turn through the one wrapper: each call packs
    (or finds) its own table's rules, and each matches the plain version
    of its own table."""
    x = torch.rand(500, 4, generator=torch.Generator().manual_seed(1))
    table, levels = build_rule_table()
    other = levels[::-1].copy()            # every level keeps a rule
    mc, mg = _mamdani("cpu"), _mamdani(cuda)
    got = {}
    for _ in range(2):
        for name, lv in (("paper", levels), ("shifted", other)):
            got.setdefault(name, []).append(ops.fuzzy_eval(
                x.to(cuda), mg[0], mg[1], table, lv, mg[2]).cpu())
    for name, lv in (("paper", levels), ("shifted", other)):
        want = ops.fuzzy_eval(x, mc[0], mc[1], table, lv, mc[2])
        assert torch.equal(got[name][0], got[name][1])
        np.testing.assert_allclose(got[name][0].numpy(), want.numpy(),
                                   rtol=0, atol=1e-4)
    assert not torch.equal(got["paper"][0], got["shifted"][0])


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


@pytest.mark.parametrize("n", [30, 257, 4096])
def test_neighbor_elect_seeds_kernel_bit_equal(cuda, n):
    """3 fleets in one launch: each seed's mask bit-equal to a launch of
    that fleet alone and to the plain seed version; tied evaluations and
    pairs exactly comm_range apart in every seed; repeatable."""
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 1000 * max(1, n // 30), (3, n)).astype(np.float32)
    ev = rng.uniform(0, 100, (3, n)).astype(np.float32)
    pos[:, :6] = [100, 300, 300, 500, 700, 900]     # d == comm_range
    ev[:, :6] = [50, 50, 50, 30, 30, 29.999]        # ties, E_tau
    ev[1, 6:12] = 50.0
    kw = dict(comm_range=200.0, top_m=2, e_tau=30.0)
    pc, ec = torch.tensor(pos, device=cuda), torch.tensor(ev, device=cuda)
    before = build.LAUNCHES["neighbor_elect"]
    got = ops.neighbor_elect(pc, ec, **kw)
    assert build.LAUNCHES["neighbor_elect"] == before + 1
    assert torch.equal(got, ops.neighbor_elect(pc, ec, **kw))
    want = ref.neighbor_elect_ref(torch.tensor(pos), torch.tensor(ev),
                                  **kw)
    assert torch.equal(got.cpu(), want)
    for i in range(3):
        assert torch.equal(got[i], ops.neighbor_elect(pc[i], ec[i], **kw))


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


# (fleet, block, window, kind, offset): R = 1 (M = 4096) and R = 4 (M =
# 65,536) CTAs, clustered fleets, blocks of 96 and 32 under 128-row CTAs,
# and arrays 4 bytes off 16-byte alignment (4-byte staging)
PARTITION_CASES = [(4096, 128, 616, "clustered", 0),
                   (65536, 128, 616, "clustered", 0),
                   (33792, 96, 616, "uniform", 0),
                   (9600, 32, 100, "uniform", 0),
                   (4096, 128, 616, "uniform", 1),
                   (65536, 128, 616, "uniform", 1)]


@pytest.mark.parametrize("n,block,window,kind,offset", PARTITION_CASES)
def test_windowed_counts_kernel_partitions_bit_equal(cuda, n, block, window,
                                                     kind, offset):
    sp, se, sg, _ = _sorted_fleet(n, n + block, float(n), cuda)
    if kind == "clustered":
        sp[n // 2:] = torch.sort(torch.rand(
            n - n // 2, device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(n)) * 150.0
        ).values + sp[n // 2 - 1]
    if offset:
        sp, se, sg = (torch.cat([t[:1], t])[1:] for t in (sp, se, sg))
        assert sp.data_ptr() % 16 != 0
    kw = dict(comm_range=200.0, e_tau=30.0, n_valid=n, window=window,
              block=block)
    got = ops.windowed_counts(sp, se, sg, **kw)
    want = ref.windowed_counts_ref(sp, se, sg, **kw)
    assert torch.equal(got, want) and int(want.sum()) > 0
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


def _wkv_inputs(b, t, h, dtype, w_dtype, device, seed=0, edge=False):
    """Model-like WKV operands: unit-scale r, k, v, decays over
    (0.37, 0.9975), a nonzero initial state.  ``edge``: every 7th decay
    exactly 0, every 11th 1e-31, every 13th 1 - 2^-24."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, 64, generator=g).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, t, h, 64, generator=g) * 6 - 6))
    if edge:
        flat = w.view(-1)
        flat[::7], flat[3::11], flat[5::13] = 0.0, 1e-31, 1 - 2 ** -24
    u = 0.5 * torch.randn(h, 64, generator=g)
    s0 = torch.randn(b, h, 64, 64, generator=g)
    return [z.to(device) for z in (r, k, v, w.to(w_dtype), u, s0)]


def _scaled_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,t,h,dtype,w_dtype", [
    (4, 64, 40, torch.bfloat16, torch.float32),    # the serving prefill
    (1, 300, 4, torch.float32, torch.float32),     # a ragged last chunk
    (2, 33, 3, torch.bfloat16, torch.bfloat16),
    (3, 1, 2, torch.float32, torch.bfloat16),
    (2, 0, 2, torch.bfloat16, torch.float32)])
def test_wkv6_kernel_matches_plain(cuda, b, t, h, dtype, w_dtype):
    """fp32 sums in another order (four partial sums, FMA): y and sT
    within 1e-5 of their largest magnitude, as on the CPU against the
    reference."""
    from repro_torch.kernels.wkv6 import wkv6_cuda
    args = _wkv_inputs(b, t, h, dtype, w_dtype, cuda)
    before = build.LAUNCHES["wkv6"]
    y, s_t = wkv6_cuda(*args)
    assert build.LAUNCHES["wkv6"] == before + 1
    want_y, want_s = ref.wkv6_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == s_t.dtype == torch.float32
    assert _scaled_err(s_t, want_s) <= 1e-5
    if t:
        assert _scaled_err(y, want_y) <= 1e-5
    # the op: the same kernel, y in r's dtype
    y_op, s_op = ops.wkv6(*args)
    assert build.LAUNCHES["wkv6"] == before + 2
    assert y_op.dtype == dtype
    assert torch.equal(y_op, y.to(dtype)) and torch.equal(s_op, s_t)


def test_wkv6_kernel_is_bit_repeatable(cuda):
    from repro_torch.kernels.wkv6 import wkv6_cuda
    args = _wkv_inputs(4, 64, 40, torch.bfloat16, torch.float32, cuda, 1)
    (y1, s1), (y2, s2) = wkv6_cuda(*args), wkv6_cuda(*args)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    y0, _ = ref.wkv6_ref(*args)
    assert _scaled_err(y1, y0) <= 1e-5


@pytest.mark.parametrize("b,t,h", [
    (1, 64, 40),       # one time chunk (C = 64): phase A alone
    (1, 65, 40),       # C + 1: phases B and C over a one-step chunk
    (1, 129, 40),      # 2C + 1
    (4, 129, 40),      # B * H = 160
    (1, 4096, 40)])    # the long prompt, 64 chunks
def test_wkv6_kernel_edge_cases_match_plain_and_repeat(cuda, b, t, h):
    """About the kernel's time chunk, with decays of exactly 0, 1e-31
    and 1 - 2^-24 and a nonzero s0: y and sT within 1e-5 of scale, one
    launch counted per call, and a second call equal bit for bit."""
    from repro_torch.kernels.wkv6 import wkv6_cuda
    args = _wkv_inputs(b, t, h, torch.bfloat16, torch.float32, cuda,
                       seed=t + b, edge=True)
    before = build.LAUNCHES["wkv6"]
    (y, s_t), (y2, s_t2) = wkv6_cuda(*args), wkv6_cuda(*args)
    assert build.LAUNCHES["wkv6"] == before + 2
    want_y, want_s = ref.wkv6_ref(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert _scaled_err(y, want_y) <= 1e-5
    assert _scaled_err(s_t, want_s) <= 1e-5
    assert torch.equal(y, y2) and torch.equal(s_t, s_t2)


def test_rwkv_prefill_launches_wkv6_once_per_layer(cuda):
    """The scaled-down model on the card: one wkv6 launch per layer at
    prefill, none in decode; logits within 2^-5 of the CPU's (bf16
    rounded in other places)."""
    cfg = scaled_down(get_arch("rwkv6-3b"))
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    on = lambda tree, dev: (tree.to(dev) if torch.is_tensor(tree) else
                            {k: on(v, dev) for k, v in tree.items()}
                            if isinstance(tree, dict) else
                            [on(v, dev) for v in tree])
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    build.reset_launches()
    want_lg, _ = registry.prefill_fn(cfg)(params, {"tokens": toks})
    got_lg, cache = registry.prefill_fn(cfg)(on(params, cuda),
                                             {"tokens": toks.to(cuda)})
    assert build.LAUNCHES["wkv6"] == cfg.num_layers
    assert _scaled_err(got_lg.cpu(), want_lg) <= 2 ** -5
    registry.decode_fn(cfg, 65)(on(params, cuda), cache,
                                toks[:, :1].to(cuda))
    assert build.LAUNCHES["wkv6"] == cfg.num_layers
    got, _ = engine.generate(cfg, on(params, cuda),
                             {"tokens": toks.to(cuda)}, 4)
    assert got.shape == (2, 4) and got.device.type == "cuda"


# flash attention at chip_smoke.py's shapes: (B, Sq, Skv, Hq, Hkv, Dh,
# causal, window, prefix_len)
FLASH_CASES = [
    (4, 64, 64, 8, 1, 256, True, 0, 0),          # gemma-2b serving prefill
    (1, 8192, 8192, 8, 1, 256, True, 0, 0),      # a long prompt
    (1, 4096, 4096, 8, 1, 256, True, 1024, 0),   # sliding window
    (2, 300, 300, 8, 1, 256, True, 0, 64),       # prefix-LM
    (2, 96, 160, 8, 1, 256, False, 0, 0),        # Sq != Skv, not causal
    (2, 200, 200, 4, 4, 64, True, 0, 0),         # Dh 64, groups of 1
    (2, 200, 200, 8, 2, 64, True, 0, 0),         # Dh 64, groups of 4
    (2, 200, 200, 4, 4, 128, True, 0, 0),        # Dh 128, groups of 1
    (2, 200, 200, 8, 2, 128, True, 0, 0),        # Dh 128, groups of 4
    (4, 1500, 1500, 16, 16, 64, False, 0, 0),    # whisper's encoder
    (4, 64, 1500, 16, 16, 64, False, 0, 0),      # its cross-attn, prefill
    (4, 1, 1500, 16, 16, 64, False, 0, 0),       # its cross-attn, decode
    (4, 320, 320, 8, 1, 256, True, 0, 256),      # paligemma's prefix-LM
    (4, 64, 64, 32, 4, 128, True, 0, 0),         # qwen3-moe, yi: groups of 8
    (4, 64, 64, 36, 36, 64, True, 0, 0),         # minicpm: 36 heads of 64
]


def _flash_inputs(b, sq, skv, hq, hkv, dh, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, dh, generator=g).to(dtype).to(device)
            for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window,prefix",
                         FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, dh,
                                              causal, window, prefix, dtype):
    """Both compute in fp32 and round the output once: fp32 within 1e-5
    of the largest |out| (sums in another order), bf16 within 2^-7 of it
    (one bf16 ulp at the largest value)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(b, sq, skv, hq, hkv, dh, dtype, cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = build.LAUNCHES["flash_attention"]
    out = flash_attention_cuda(q, k, v, **kw)
    assert build.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out.float(), want.float()) <= (
        1e-5 if dtype == torch.float32 else 2 ** -7)
    assert torch.equal(ops.flash_attention(q, k, v, **kw), out)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal", [
    (3, 1, 100, 8, 2, 128, True),        # Sq = 1: position 0 keeps kv 0
    (2, 1, 77, 6, 3, 64, False),         # Sq = 1 over all of Skv
    (2, 130, 131, 3, 1, 256, True),      # Skv one past 2 kv tiles
    (1, 200, 333, 4, 2, 128, False),     # Skv not a multiple of 64
])
def test_flash_attention_bf16_edge_shapes(cuda, b, sq, skv, hq, hkv, dh,
                                          causal):
    """The tensor-core kernel at Sq = 1 and at ragged Skv (the kv tile's
    zero-filled rows masked): 2^-7 of the largest |out|, bit-repeatable."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(b, sq, skv, hq, hkv, dh, torch.bfloat16, cuda)
    out = flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out.float(), want.float()) <= 2 ** -7
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal))


def test_flash_attention_kernel_is_bit_repeatable(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(1, 4096, 4096, 8, 1, 256, torch.bfloat16, cuda,
                            seed=1)
    a = flash_attention_cuda(q, k, v, window=1024)
    assert torch.equal(a, flash_attention_cuda(q, k, v, window=1024))


def test_flash_attention_kernel_refuses_what_it_was_not_built_for(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(1, 8, 8, 2, 1, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash_attention_cuda(q, k, v)
    q, k, v = _flash_inputs(1, 8, 8, 3, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window,prefix",
                         FLASH_CASES[:1] + FLASH_CASES[2:])
def test_flash_attention_lse_matches_plain_and_keeps_the_output(
        cuda, b, sq, skv, hq, hkv, dh, causal, window, prefix, dtype):
    """The forward with its log-sum-exp written: lse within 1e-5 of the
    largest |lse| of the plain version's (sums in another order), and
    the output bit-equal to the forward's without it (serving's bits)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(b, sq, skv, hq, hkv, dh, dtype, cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, want = ref.flash_attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert _scaled_err(lse, want) <= 1e-5
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))


# the backward at chip_smoke.py's training shapes and at edges: (B, Sq,
# Skv, Hq, Hkv, Dh, causal, window, prefix_len)
FLASH_BWD_CASES = [
    (2, 1024, 1024, 8, 1, 256, True, 0, 0),      # gemma-2b training
    (1, 1024, 1024, 8, 1, 256, True, 0, 0),      # its microbatch of 1
    (2, 1024, 1024, 36, 36, 64, True, 0, 0),     # minicpm-2b training
    (2, 1024, 1024, 12, 4, 128, True, 0, 0),     # groups of 3
    (2, 512, 512, 16, 1, 64, True, 0, 0),        # a group past 8 splits
    (2, 1024, 1024, 32, 8, 128, True, 0, 0),     # Dh 128, groups of 4
    (2, 1024, 1024, 8, 1, 256, True, 256, 0),    # sliding window
    (2, 320, 320, 8, 1, 256, True, 0, 256),      # paligemma's prefix-LM
    (2, 1500, 1500, 16, 16, 64, False, 0, 0),    # unmasked
    (1, 448, 1500, 16, 16, 64, False, 0, 0),     # whisper's cross-attention
    (2, 77, 77, 4, 4, 128, True, 0, 0),          # ragged tiles
    (2, 200, 200, 8, 2, 64, True, 40, 0),        # a window under a tile
    (2, 130, 100, 8, 8, 64, True, 0, 70),        # Sq > Skv, prefix
    (2, 96, 160, 8, 1, 256, False, 0, 0),        # Sq != Skv, not causal
]


def flash_bwd_inputs(case, dtype, device, seed=0):
    """q, k, v, the forward kernel's o and lse, and a cotangent dO."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b, sq, skv, hq, hkv, dh, causal, window, prefix = case
    q, k, v = _flash_inputs(b, sq, skv, hq, hkv, dh, dtype, device, seed)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g).to(dtype).to(device)
    return (q, k, v, o, lse, do), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, case, dtype):
    """dq, dk, dv against the plain version's explicit formulas on the
    same o and lse: fp32 within 1e-5 of each gradient's largest
    magnitude (sums in another order), bf16 within 2^-7 of it (P and dS
    rounded to bf16 for their products, the gradients once);
    bit-repeatable; one launch a call."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    args, kw = flash_bwd_inputs(case, dtype, cuda)
    before = build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(*args, **kw)
    assert build.LAUNCHES["flash_attention_bwd"] == before + 1
    want = ref.flash_attention_bwd_ref(*args, **kw)
    again = flash_attention_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, x, w, y in zip(("dq", "dk", "dv"), got, want, again):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert bool(torch.isfinite(x).all()), name
        assert _scaled_err(x.float(), w.float()) <= tol, name
        assert torch.equal(x, y), name


def test_flash_attention_autograd_runs_the_kernels(cuda):
    """With grad required, ``ops.flash_attention`` is the autograd
    Function: one forward launch (with lse) and, in backward, one
    backward launch whose gradients are the kernel's bit for bit; under
    no_grad it is the serving call, the same bits and no lse."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    case = (2, 256, 256, 8, 2, 128, True, 0, 0)
    (q, k, v, o, lse, do), kw = flash_bwd_inputs(case, torch.bfloat16, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    build.reset_launches()
    out = ops.flash_attention(*leaves, **kw)
    assert build.LAUNCHES["flash_attention"] == 1
    assert torch.equal(out.detach(), o)
    out.backward(do)
    assert build.LAUNCHES["flash_attention_bwd"] == 1
    for x, w in zip(leaves, flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                     **kw)):
        assert torch.equal(x.grad, w)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(*leaves, **kw), o)
    assert torch.equal(flash_attention_cuda(q, k, v, **kw), o)


def test_flash_attention_bwd_refuses_what_it_was_not_built_for(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    args, kw = flash_bwd_inputs((1, 8, 8, 2, 1, 64, True, 0, 0),
                                torch.float32, cuda)
    q, k, v, o, lse, do = args
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, k, v, o, lse.double(), do, **kw)
    with pytest.raises(ValueError, match="do"):
        flash_attention_bwd_cuda(q, k, v, o, lse, do[:, :4].contiguous(),
                                 **kw)
    with pytest.raises(ValueError, match="expected"):
        flash_attention_bwd_cuda(q, k, v, o.bfloat16(), lse, do, **kw)


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


@pytest.mark.parametrize("arch,fp32", [("gemma-2b", False),
                                       ("paligemma-3b", False),
                                       ("qwen3-moe-30b-a3b", True)])
def test_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch, arch,
                                                fp32):
    """One scaled-down train step (2 layers, d_model 256, head_dim 128,
    B = 4, S = 64 in 2 microbatches) on the card against the CPU from the
    same parameters and batch, the step the clipped gradient itself (lr
    1, eps 1, no decay): loss and grad_norm, and every parameter's update
    within 2^-5 of its largest element in bf16 (cuBLAS against the CPU's
    GEMMs, the kernels' bf16 P against the plain fp32), 1e-4 in fp32 (the
    MoE, whose bf16 router near-ties could send a token elsewhere on one
    side); 2 x 2 x 2 forward and 2 x 2 backward flash launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import transformer
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    if fp32:
        monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    cfg = scaled_down(get_arch(arch))
    if cfg.is_moe:      # a capacity that drops nothing
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                  / cfg.experts_per_token)
    shape = ShapeConfig("t", 64, 4, "train", grad_accum=2)
    step = make_train_step(cfg, shape, optim.OptConfig(
        lr=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0))
    p_dev = registry.init_params(torch.Generator(device=cuda).manual_seed(0),
                                 cfg)
    p_cpu, before = _to(p_dev, "cpu"), _to(p_dev, "cpu")
    batch = registry.make_concrete_batch(cfg, shape,
                                         torch.Generator().manual_seed(1),
                                         "train")
    build.reset_launches()
    p_dev, _, m_dev = step(p_dev, optim.adamw_init(p_dev), _to(batch, cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 8
    assert build.LAUNCHES["flash_attention_bwd"] == 4
    p_cpu, _, m_cpu = step(p_cpu, optim.adamw_init(p_cpu), batch)
    tol = 1e-4 if fp32 else 2 ** -5
    for k in ("loss", "grad_norm"):
        assert abs(float(m_dev[k]) - float(m_cpu[k])) <= tol * abs(
            float(m_cpu[k])), k
    for d, c, p0 in zip(optim.tree_leaves(p_dev), optim.tree_leaves(p_cpu),
                        optim.tree_leaves(before)):
        scale = float((c - p0).abs().max())
        assert bool(((d.cpu() - c).abs() <= tol * scale
                     + 2 ** -22 * c.abs()).all())


def test_gemma_prefill_launches_flash_attention_once_per_layer(cuda):
    """Scaled-down gemma-2b with its 18 layers on the card: one
    flash_attention launch per layer at prefill, none in decode; logits
    within 2^-5 of the CPU's (bf16 rounded in other places)."""
    cfg = scaled_down(get_arch("gemma-2b"), layers=18)
    params = registry.serving_params(registry.init_params(
        torch.Generator().manual_seed(0), cfg))
    on = lambda tree, dev: (tree.to(dev) if torch.is_tensor(tree) else
                            {k: on(v, dev) for k, v in tree.items()}
                            if isinstance(tree, dict) else
                            [on(v, dev) for v in tree])
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    prefill = registry.prefill_fn(cfg)
    want_lg, want_cache = prefill(params, {"tokens": toks}, context=72)
    build.reset_launches()
    got_lg, cache = prefill(on(params, cuda), {"tokens": toks.to(cuda)},
                            context=72)
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers == 18
    assert _scaled_err(got_lg.cpu(), want_lg) <= 2 ** -5
    for a, b in zip(cache["layers"], want_cache["layers"]):
        assert torch.equal(a["pos"].cpu(), b["pos"])
        assert _scaled_err(a["k"].float().cpu(), b["k"].float()) <= 2 ** -5
    registry.decode_fn(cfg, 72)(on(params, cuda), cache,
                                toks[:, :1].to(cuda))
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers
    assert sum(build.LAUNCHES.values()) == cfg.num_layers
    got, _ = engine.generate(cfg, on(params, cuda),
                             {"tokens": toks.to(cuda)}, 4)
    assert got.shape == (2, 4) and got.device.type == "cuda"


def _on(tree, dev):
    return (tree.to(dev) if torch.is_tensor(tree) else
            {k: _on(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else [_on(v, dev) for v in tree])


def _zoo_batch(cfg, tokens=64, seed=1):
    """``tokens`` random tokens for 2 prompts, and the vlm family's patch
    or the audio family's frame embeddings (bf16), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return dict(tokens=torch.randint(0, cfg.vocab_size, (2, tokens),
                                     generator=g),
                **registry.stub_inputs(cfg, 2, g))


@pytest.mark.parametrize("arch", ["yi-6b", "granite-8b", "minicpm-2b",
                                  "paligemma-3b", "qwen3-moe-30b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_zoo_prefill_launches_flash_attention_once_per_layer(
        cuda, arch, monkeypatch):
    """Each dense, vlm and moe arch scaled down with its own number of
    layers on the card: one flash_attention launch per layer at prefill
    (paligemma's over its prefix and tokens, prefix-LM), none in decode,
    no other kernel; logits and slot caches within 2^-5 of the CPU's.
    The moe archs compute in fp32 here (the compute dtype
    monkeypatched): in bf16 a router near-tie may send a token to
    another expert on one side (ROADMAP C3)."""
    from repro_torch.models import transformer
    n = get_arch(arch).num_layers
    cfg = scaled_down(get_arch(arch), layers=n)
    if cfg.is_moe:
        monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    params = registry.serving_params(registry.init_params(
        torch.Generator().manual_seed(0), cfg))
    batch = _zoo_batch(cfg)
    ctx = 64 + cfg.num_prefix_tokens + 8
    prefill = registry.prefill_fn(cfg)
    want_lg, want_cache = prefill(params, batch, context=ctx)
    build.reset_launches()
    got_lg, cache = prefill(_on(params, cuda), _on(batch, cuda), context=ctx)
    assert build.LAUNCHES["flash_attention"] == n
    assert sum(build.LAUNCHES.values()) == n
    assert _scaled_err(got_lg.cpu(), want_lg) <= 2 ** -5
    for a, b in zip(cache["layers"], want_cache["layers"]):
        assert torch.equal(a["pos"].cpu(), b["pos"])
        assert _scaled_err(a["k"].float().cpu(), b["k"].float()) <= 2 ** -5
    registry.decode_fn(cfg, ctx)(_on(params, cuda), cache,
                                 batch["tokens"][:, :1].to(cuda))
    assert sum(build.LAUNCHES.values()) == n
    got, info = engine.generate(cfg, _on(params, cuda), _on(batch, cuda), 4)
    assert got.shape == (2, 4) and got.device.type == cuda.type
    assert info["prompt_len"] == 64 + cfg.num_prefix_tokens


def test_whisper_launches_flash_attention_in_prefill_and_each_decode_step(
        cuda):
    """Scaled-down whisper-medium with its 24 encoder and 24 decoder
    layers on the card: 72 flash_attention launches at prefill (each
    encoder layer, each decoder layer's self- and cross-attention) and
    24 at each decode step (the cross-attention, one query over the
    encoder's positions), no other kernel; logits, slot caches and the
    encoder K/V within 2^-5 of the CPU's."""
    cfg = scaled_down(get_arch("whisper-medium"), layers=24)
    assert (cfg.encoder_layers, cfg.num_layers) == (24, 24)
    params = registry.serving_params(registry.init_params(
        torch.Generator().manual_seed(0), cfg))
    batch = _zoo_batch(cfg)
    prefill, decode = registry.prefill_fn(cfg), registry.decode_fn(cfg, 72)
    tok = batch["tokens"][:, :1]
    want_lg, want_cache = prefill(params, batch, context=72)
    want_step, _ = decode(params, want_cache, tok)
    build.reset_launches()
    got_lg, cache = prefill(_on(params, cuda), _on(batch, cuda), context=72)
    assert build.LAUNCHES["flash_attention"] == 72
    assert sum(build.LAUNCHES.values()) == 72
    assert _scaled_err(got_lg.cpu(), want_lg) <= 2 ** -5
    for key in ("cross_k", "cross_v"):
        for a, b in zip(cache[key], want_cache[key]):
            assert _scaled_err(a.float().cpu(), b.float()) <= 2 ** -5
    got_lg, _ = decode(_on(params, cuda), cache, tok.to(cuda))
    assert build.LAUNCHES["flash_attention"] == 72 + 24
    assert sum(build.LAUNCHES.values()) == 72 + 24
    assert _scaled_err(got_lg.cpu(), want_step) <= 2 ** -5


# the selective scan at chip_smoke.py's shapes: (B, T, Di, N); the first
# is jamba's serving prefill (Di = 2 x 4096), the second a long prompt,
# the third an odd Di and T with N under 8 (padded), then N = 32 (4
# states a lane) at the long prompt and a Di that is no multiple of a
# block's 16 channels
SCAN_CASES = [(4, 64, 8192, 16), (1, 4096, 8192, 16), (3, 77, 300, 7),
              (1, 4096, 8192, 32), (2, 100, 8200, 16)]


def _scan_inputs(b, t, di, n, dtype, device, seed=0):
    """Model-like scan operands: unit-scale x, B and C, dt a softplus of
    small values, negative a, a nonzero initial state."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, di, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, t, di, generator=g) - 4)
    bm, cm = (torch.randn(b, t, n, generator=g) for _ in range(2))
    a = -torch.exp(0.5 * torch.randn(di, n, generator=g))
    h0 = 0.1 * torch.randn(b, di, n, generator=g)
    return [z.to(dtype).to(device) for z in (x, dt, bm, cm)] + \
        [a.to(device), h0.to(device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,di,n", SCAN_CASES)
def test_selective_scan_kernel_matches_plain(cuda, b, t, di, n, dtype):
    """Both compute in fp32 from the same operands (bf16 inputs
    converted once): y and hT within 1e-5 of their largest magnitude
    (sums in another order, FMA)."""
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    args = _scan_inputs(b, t, di, n, dtype, cuda)
    before = build.LAUNCHES["selective_scan"]
    y, h_t = selective_scan_cuda(*args)
    assert build.LAUNCHES["selective_scan"] == before + 1
    want_y, want_h = ref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == h_t.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert _scaled_err(y, want_y) <= 1e-5
    assert _scaled_err(h_t, want_h) <= 1e-5
    # the op: the same kernel, y in x's dtype
    y_op, h_op = ops.selective_scan(*args)
    assert y_op.dtype == dtype
    assert torch.equal(y_op, y.to(dtype)) and torch.equal(h_op, h_t)


def test_selective_scan_kernel_is_bit_repeatable(cuda):
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    args = _scan_inputs(4, 64, 8192, 16, torch.bfloat16, cuda, seed=1)
    (y1, h1), (y2, h2) = selective_scan_cuda(*args), selective_scan_cuda(*args)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("b,t,di,n", SCAN_CASES)
def test_selective_scan_kernel_repeats_at_every_case(cuda, b, t, di, n):
    """bf16 inputs: a second call equal bit for bit (the lanes' partial
    sums meet in a fixed shuffle tree; no atomics)."""
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    args = _scan_inputs(b, t, di, n, torch.bfloat16, cuda, seed=2)
    (y1, h1), (y2, h2) = selective_scan_cuda(*args), selective_scan_cuda(*args)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_selective_scan_kernel_refuses_what_it_was_not_built_for(cuda):
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    with pytest.raises(ValueError, match="N = 40"):
        selective_scan_cuda(*_scan_inputs(1, 8, 64, 40, torch.float32, cuda))
    x, dt, bm, cm, a, h0 = _scan_inputs(1, 8, 64, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="dt"):
        selective_scan_cuda(x, dt.to(torch.bfloat16), bm, cm, a, h0)
    with pytest.raises(ValueError, match="bmat"):
        selective_scan_cuda(x, dt, bm.to(torch.bfloat16), cm, a, h0)


def test_jamba_prefill_launches_selective_scan_once_per_mamba_layer(
        cuda, monkeypatch):
    """Scaled-down jamba with 4 groups (8 layers: attention + MLP, mamba
    + MoE) on the card: one selective_scan launch per mamba layer and one
    flash_attention launch per attention layer at prefill, none in
    decode; logits and caches within 2^-5 of the CPU's.  The model
    computes in fp32 here (the compute dtype monkeypatched): in bf16 a
    router near-tie may send a token to another expert on one side
    (ROADMAP C3)."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    cfg = scaled_down(get_arch("jamba-v0.1-52b"), layers=8)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    on = lambda tree, dev: (tree.to(dev) if torch.is_tensor(tree) else
                            {k: on(v, dev) for k, v in tree.items()}
                            if isinstance(tree, dict) else
                            [on(v, dev) for v in tree])
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    prefill = registry.prefill_fn(cfg)
    want_lg, want_cache = prefill(params, {"tokens": toks}, context=72)
    build.reset_launches()
    got_lg, cache = prefill(on(params, cuda), {"tokens": toks.to(cuda)},
                            context=72)
    assert build.LAUNCHES["selective_scan"] == 4
    assert build.LAUNCHES["flash_attention"] == 4
    assert sum(build.LAUNCHES.values()) == 8
    assert _scaled_err(got_lg.cpu(), want_lg) <= 2 ** -5
    for a, b in zip(cache["layers"], want_cache["layers"]):
        for key in ("k", "h"):
            if key in a:
                assert _scaled_err(a[key].float().cpu(),
                                   b[key].float()) <= 2 ** -5
    registry.decode_fn(cfg, 72)(on(params, cuda), cache,
                                toks[:, :1].to(cuda))
    assert sum(build.LAUNCHES.values()) == 8
    got, _ = engine.generate(cfg, on(params, cuda),
                             {"tokens": toks.to(cuda)}, 4)
    assert got.shape == (2, 4) and got.device.type == "cuda"


# -- C8: the loop and batched engines in fp32 on the card --------------------


def _engines_fixture(cuda):
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.fl_sim import fast_config
    return {e: FLSimulation(fast_config("dcs", n_rounds=3),
                            run=RunConfig(engine=e), device=cuda)
            for e in ("loop", "batched")}


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


def test_sgd_step_alone_and_in_a_cohort_agree_op_by_op(cuda, deterministic):
    """One local-SGD step of a client trained alone (the loop engine's
    cohort of one) and in its round-0 cohort of four (the batched
    engine's), op by op: the stacked convolutions, the logits, the loss
    and every gradient bit for bit, every product a ``cohort_gemm``
    whose sums run in an order set by their own sizes (ROADMAP C8, C12;
    cuBLAS's batched GEMMs gave ~1e-6, cuDNN's grouped convolution
    ~1e-4)."""
    import torch.nn.functional as F
    from repro_torch.fl.pipeline import cohort_bucket
    from repro_torch.models.cnn import (_stacked_conv_gemm, _stacked_linear,
                                        sample_nll)
    sim = _engines_fixture(cuda)["batched"]
    fields = sim.round_fields(0)
    surv = sim._host(sim.selection_state(0, fields))["survivors"]
    g = sim.groups[0]
    cohort = np.where(surv[g.client_ids])[0]
    idx = np.concatenate([cohort, np.full(
        cohort_bucket(len(cohort)) - len(cohort), cohort[0])])
    b = sim.cfg.batch_size

    def step(c_idx):
        perm = torch.stack([fields.perms[int(g.client_ids[i])][0]
                            for i in c_idx]).to(cuda)
        rows = torch.arange(len(c_idx), device=cuda)[:, None]
        images = torch.as_tensor(g.images[c_idx], device=cuda)[rows, perm][
            :, :b]
        labels = torch.as_tensor(g.labels[c_idx], device=cuda)[rows, perm][
            :, :b]
        p = {k: v[None].expand(len(c_idx), *v.shape).clone()
             .requires_grad_(True) for k, v in sim.params.items()}
        out = {}
        c = len(c_idx)
        x = images.permute(1, 0, 4, 2, 3).reshape(b, -1, 28, 28)
        for name in ("conv1", "conv2"):
            x = _stacked_conv_gemm(x, p[name + ".w"], p[name + ".b"])
            out[name] = x.reshape(b, c, -1, *x.shape[-2:]).transpose(0, 1)
            x = F.max_pool2d(F.relu(x), 2)
        x = x.reshape(b, c, -1, 7, 7).permute(1, 0, 3, 4, 2).reshape(c, b, -1)
        x = F.relu(_stacked_linear(x, p["fc1.w"], p["fc1.b"]))
        out["logits"] = _stacked_linear(x, p["fc2.w"], p["fc2.b"])
        out["loss"] = sample_nll(out["logits"], labels).mean(-1)
        grads = torch.autograd.grad(out["loss"].sum(), list(p.values()))
        out.update({"grad " + k: v for k, v in zip(p, grads)})
        return {k: v.detach()[0] for k, v in out.items()}

    alone, in_cohort = step(idx[:1]), step(idx)
    assert len(idx) == 4
    for k, want in in_cohort.items():
        assert torch.equal(alone[k], want), k


def test_engine_contract_holds_over_three_fast_rounds(cuda):
    """ROADMAP C12: 3 fast ``dcs`` rounds in the loop and the batched
    engine on the same draws, with the default algorithms, hold the
    reference's engine contract (``tests/test_engine_parity.py``): masks,
    ``n_selected``, ``n_aggregated`` and ``n_straggler`` equal, accuracy
    within 1e-5; the params within 1e-6 (only FedAvg's sums differ: the
    list average in client order, the masked one in group order)."""
    sims = _engines_fixture(cuda)
    for rnd in range(3):
        rows = {e: s.run_round(rnd) for e, s in sims.items()}
        assert np.array_equal(sims["loop"].last_mask,
                              sims["batched"].last_mask)
        for k in ("n_selected", "n_aggregated", "n_straggler"):
            assert rows["loop"][k] == rows["batched"][k], (rnd, k)
        assert abs(rows["loop"]["accuracy"]
                   - rows["batched"]["accuracy"]) <= 1e-5
        gap = max(float((sims["loop"].params[k]
                         - sims["batched"].params[k]).abs().max())
                  for k in sims["loop"].params)
        assert gap <= 1e-6, (rnd, gap)
    assert rows["loop"]["n_aggregated"] > 0


@pytest.mark.parametrize("z1,z2,r,m,k,n", [(32, 3, 1, 64, 800, 196),
                                           (1, 5, 1, 32, 3136, 512),
                                           (1, 3, 32, 64, 196, 800),
                                           (2, 3, 2, 7, 33, 65),
                                           (2, 3, 3, 7, 70, 5),
                                           (1, 3, 1, 20, 3136, 512),
                                           (1, 3, 20, 64, 196, 1),
                                           (1, 3, 1, 20, 512, 10),
                                           (1, 3, 20, 32, 784, 25),
                                           (1, 3, 1, 1, 20, 512),
                                           (20, 3, 1, 800, 64, 196)])
def test_cohort_gemm_matches_plain_and_is_batch_invariant(cuda, z1, z2, r,
                                                          m, k, n):
    """The cohort GEMM on strided views (a broadcast and a transposed
    operand, a bias) within 1e-5 of its plain version's scale, bit for bit
    from call to call, and each cohort member's (Z2) matrices equal to a
    launch of that member alone; the cases run the kernel at every tile
    (16 to 64 rows, 32 or 64 columns), with one run of k chunks and
    with 2, 4 and 8 (``gemm_plan``), and at a step's awkward shapes: M =
    20 (fc1, fc2), N = 1, N = 10 (fc2), N = 25 with R = 20 (conv1's
    weight gradient), M = 1, and conv2's input gradient."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(z2, r, m, k, device=cuda, generator=g)[None].expand(
        z1, z2, r, m, k)
    b = torch.randn(z1, z2, r, n, k, device=cuda,
                    generator=g).transpose(3, 4)
    bias = torch.randn(z2, m, device=cuda, generator=g)[None, :, :, None] \
        .expand(z1, z2, m, n)
    before = build.LAUNCHES["cohort_gemm"]
    got = ops.cohort_gemm(a, b, bias)
    assert build.LAUNCHES["cohort_gemm"] == before + 1
    want = ref.cohort_gemm_ref(a, b, bias)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(ops.cohort_gemm(a, b, bias), got)
    one = ops.cohort_gemm(a[:, -1:], b[:, -1:], bias[:, -1:])
    assert torch.equal(one[:, 0], got[:, -1])


@pytest.mark.parametrize("r,m,k,n,a_t", [(20, 64, 196, 800, False),
                                         (20, 32, 784, 25, False),
                                         (1, 512, 20, 3136, True),
                                         (1, 10, 20, 512, True)])
def test_cohort_gemm_fused_bias_gradient(cuda, r, m, k, n, a_t):
    """A weight gradient with its bias gradient in one launch, at the
    step's four (conv2, conv1, fc1, fc2; a transposed where the dense
    layers' is): the product and a's row sums over (r, k) within 1e-5 of
    the plain version's scale, bit-repeatable, and a member's alone
    bit-equal to its block in a cohort of 3."""
    g = torch.Generator(device=cuda).manual_seed(r + m + n)
    z2 = 3
    if a_t:
        a = torch.randn(1, z2, r, k, m, device=cuda,
                        generator=g).transpose(3, 4)
    else:
        a = torch.randn(1, z2, r, m, k, device=cuda, generator=g)
    b = torch.randn(1, z2, r, n, k, device=cuda, generator=g).transpose(3, 4)
    before = build.LAUNCHES["cohort_gemm"]
    got, rs = ops.cohort_gemm(a, b, rowsum=True)
    assert build.LAUNCHES["cohort_gemm"] == before + 1
    want, want_rs = ref.cohort_gemm_ref(a, b, rowsum=True)
    assert rs.shape == (1, z2, m)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert float((rs - want_rs).abs().max() / want_rs.abs().max()) <= 1e-5
    again, again_rs = ops.cohort_gemm(a, b, rowsum=True)
    assert torch.equal(again, got) and torch.equal(again_rs, rs)
    one, one_rs = ops.cohort_gemm(a[:, -1:], b[:, -1:], rowsum=True)
    assert torch.equal(one[:, 0], got[:, -1])
    assert torch.equal(one_rs[:, 0], rs[:, -1])


def test_cohort_gemm_fp64_matches_plain(cuda):
    """The fp64 path (the CUDA-core tile, split runs through its slab,
    the row sums as a second product) within 1e-12 of its plain
    version's scale, a member alone bit-equal to its block."""
    g = torch.Generator(device=cuda).manual_seed(64)
    a = torch.randn(1, 3, 20, 32, 784, device=cuda, generator=g,
                    dtype=torch.float64)
    b = torch.randn(1, 3, 20, 25, 784, device=cuda, generator=g,
                    dtype=torch.float64).transpose(3, 4)
    got, rs = ops.cohort_gemm(a, b, rowsum=True)
    want, want_rs = ref.cohort_gemm_ref(a, b, rowsum=True)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert float((rs - want_rs).abs().max() / want_rs.abs().max()) <= 1e-12
    one, one_rs = ops.cohort_gemm(a[:, -1:], b[:, -1:], rowsum=True)
    assert torch.equal(one[:, 0], got[:, -1])
    assert torch.equal(one_rs[:, 0], rs[:, -1])


def test_probe_loss_seed_axis_is_single_launches(cuda):
    """``probe_loss`` with a leading axis of 4 seeds: one launch, each
    seed's row bit-equal to a launch of that seed alone."""
    fxs = [_probe_inputs(cuda, seed=s) for s in range(4)]
    n = fxs[0]["n"]
    stack = lambda key: torch.stack([fx[key] for fx in fxs])
    params = {k: torch.stack([fx["params"][k] for fx in fxs])
              for k in fxs[0]["params"]}
    before = build.LAUNCHES["probe_loss"]
    got = ops.probe_loss(params, stack("images"), stack("labels"),
                         stack("seg"), stack("counts"), n_clients=n)
    assert build.LAUNCHES["probe_loss"] == before + 1
    for i, fx in enumerate(fxs):
        alone = ops.probe_loss(fx["params"], fx["images"], fx["labels"],
                               fx["seg"], fx["counts"], n_clients=n)
        assert torch.equal(got[i], alone)


@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("p", [30, 4096, 70_000])
def test_fuzzy_eval_seed_axis_is_single_launches(cuda, external, p):
    """``fuzzy_eval`` on (4, P, 4) raw features, Eq. 8 over each seed's
    own rows or its row of external maxima: one launch, each seed
    bit-equal to a launch of it alone and within 1e-4 of the plain
    version."""
    gen = torch.Generator().manual_seed(p)
    x = torch.rand(4, p, 4, generator=gen) * torch.tensor([4500., 3e6, 1.,
                                                           3.])
    cm = (x.max(dim=1).values * 1.1) if external else None
    table, levels = build_rule_table()
    m = _mamdani(cuda)
    xc, cmc = x.to(cuda), None if cm is None else cm.to(cuda)
    before = build.LAUNCHES["fuzzy_eval"]
    got = ops.fuzzy_eval(xc, m[0], m[1], table, levels, m[2],
                         normalize=True, col_maxima=cmc)
    assert build.LAUNCHES["fuzzy_eval"] == before + 1
    for i in range(4):
        alone = ops.fuzzy_eval(xc[i], m[0], m[1], table, levels, m[2],
                               normalize=True,
                               col_maxima=None if cmc is None else cmc[i])
        assert torch.equal(got[i], alone)
    want = ops.fuzzy_eval(x, *_mamdani("cpu")[:2], table, levels,
                          _mamdani("cpu")[2], normalize=True, col_maxima=cm)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)


def test_loop_and_batched_engines_agree_in_fp32(cuda, deterministic):
    """Fast round 0 in both engines on the card, fp32: the masks and
    integer columns equal, accuracy within the reference's 1e-5
    (tests/test_engine_parity.py), the global params within 1e-5."""
    sims = _engines_fixture(cuda)
    rows = {e: s.run_round(0) for e, s in sims.items()}
    assert np.array_equal(sims["loop"].last_mask, sims["batched"].last_mask)
    for k in ("n_selected", "n_aggregated", "n_straggler"):
        assert rows["loop"][k] == rows["batched"][k]
    assert rows["loop"]["n_aggregated"] > 0
    assert abs(rows["loop"]["accuracy"] - rows["batched"]["accuracy"]) <= 1e-5
    gap = max(float((sims["loop"].params[k]
                     - sims["batched"].params[k]).abs().max())
              for k in sims["loop"].params)
    assert gap <= 1e-5, gap


# -- the round drivers: round-ahead schedule, churn-gated elections --------


def _tiny_sim(cuda, **run):
    """The parity tests' 10-client profile on the card."""
    from repro_torch.fl.mobility import MobilityConfig
    from repro_torch.fl.partition import PartitionConfig
    from repro_torch.fl.rounds import FLSimConfig, FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    cfg = FLSimConfig(
        scheme="dcs", n_rounds=3, local_epochs=1, samples_per_class=260,
        probe_samples=64,
        partition=PartitionConfig(n_clients=10, big_clients=3,
                                  big_quantity=120, small_quantity=40),
        mobility=MobilityConfig(n_vehicles=10))
    return FLSimulation(cfg, run=RunConfig(**run), device=cuda)


@pytest.mark.parametrize("run", [{}, dict(churn_rate=0.2,
                                          staleness="weighted",
                                          staleness_lambda=0.5,
                                          agg_cadence_s=90.0)],
                         ids=["sync", "event"])
def test_round_ahead_is_the_serial_schedule_on_the_card(cuda, run):
    """3 rounds round-ahead and serially from the same params: rows and
    params bit-equal (the card's training repeats bit for bit)."""
    sim = _tiny_sim(cuda, **run)
    params0 = {k: v.clone() for k, v in sim.params.items()}
    out = []
    for overlap in (True, False):
        sim.params = {k: v.clone() for k, v in params0.items()}
        out.append((sim.run(3, overlap=overlap), sim.params))
    (rows_a, p_a), (rows_b, p_b) = out
    assert rows_a == rows_b
    assert all(torch.equal(p_a[k], p_b[k]) for k in p_a)


def test_round_ahead_stretch_does_not_synchronise(cuda):
    """From each round's training dispatch through the next prefix's
    enqueue nothing waits for the card: the stretch runs under
    ``set_sync_debug_mode("error")``."""
    import contextlib

    from repro_torch.fl.rounds import run_schedule

    @contextlib.contextmanager
    def no_sync(r):
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    sim = _tiny_sim(cuda)
    rows = run_schedule(sim, sim, 3, overlap=True, stretch=no_sync)
    assert len(rows) == 3 and rows[-1]["n_selected"] > 0


@pytest.mark.parametrize("n", [30, 4096])
def test_elections_on_churn_gated_evals_bit_equal(cuda, n):
    """Departed clients' evals at +0.0 (many exact ties below E_tau): the
    dense kernel and the windowed counts bit-equal to their plain
    versions, the windowed mask the dense one wherever its flag is 0."""
    from repro_torch.fl.mobility import coverage_active
    rng = np.random.default_rng(n)
    pos = torch.tensor(rng.uniform(0, n, n).astype(np.float32))
    ev = torch.tensor(rng.uniform(0, 100, n).astype(np.float32))
    ev = torch.where(coverage_active(pos, road_length_m=float(n),
                                     churn_rate=0.2), ev, torch.zeros(()))
    kw = dict(comm_range=200.0, top_m=2, e_tau=30.0)
    pc, ec = pos.to(cuda), ev.to(cuda)
    dense = ops.neighbor_elect(pc, ec, **kw)
    assert torch.equal(dense.cpu(), ref.neighbor_elect_ref(pos, ev, **kw))
    order = torch.argsort(pc, stable=True)
    pad = -(-n // 128) * 128 - n             # the election's sentinels
    sp = torch.cat([pc[order], torch.full((pad,), elect.SENT_POS,
                                          device=cuda)])
    se = torch.cat([ec[order], torch.full((pad,), elect.SENT_EV,
                                          device=cuda)])
    sg = torch.cat([order.to(torch.int32),
                    torch.full((pad,), n, dtype=torch.int32, device=cuda)])
    wkw = dict(comm_range=200.0, e_tau=30.0, n_valid=n, window=64,
               block=128)
    assert torch.equal(ops.windowed_counts(sp, se, sg, **wkw).cpu(),
                       ref.windowed_counts_ref(sp.cpu(), se.cpu(), sg.cpu(),
                                               **wkw))
    mask, ovf = ops.neighbor_elect_windowed(pc, ec, window=64, **kw)
    assert int(ovf) == 1 or torch.equal(mask, dense)


# -- checkpoints: the card and the CPU share snapshots -------------------


def test_snapshots_cross_between_the_card_and_the_cpu(cuda, tmp_path):
    """A snapshot written on the card restores into a CPU simulation and
    one written on the CPU onto the card: the params bit-equal after
    each round trip, the counters and mask equal."""
    from repro_torch.train.checkpoint import load_state, save_state
    card = _tiny_sim(cuda)
    card.run(1)
    cpu = _tiny_sim("cpu")
    save_state(str(tmp_path / "card"), card.capture_state())
    cpu.restore_state(*load_state(str(tmp_path / "card")))
    assert all(torch.equal(cpu.params[k], card.params[k].cpu())
               for k in card.params)
    assert np.array_equal(cpu.participation, card.participation)
    assert np.array_equal(cpu.last_mask, card.last_mask)
    cpu.run(1)
    save_state(str(tmp_path / "cpu"), cpu.capture_state())
    card.restore_state(*load_state(str(tmp_path / "cpu")))
    assert all(card.params[k].is_cuda
               and torch.equal(card.params[k].cpu(), cpu.params[k])
               for k in cpu.params)


@pytest.mark.parametrize("run", [{}, dict(churn_rate=0.2,
                                          staleness="weighted",
                                          staleness_lambda=0.5,
                                          agg_cadence_s=90.0)],
                         ids=["sync", "event"])
def test_kill_and_resume_on_the_card(cuda, tmp_path, run):
    """3 rounds uninterrupted against 1 with snapshots and a fresh
    simulation resumed to 3: rows and params bit-equal on the card."""
    from repro_torch.train.checkpoint import RoundCheckpointer
    full = _tiny_sim(cuda, **run)
    rows = full.run(3)
    ck = RoundCheckpointer(str(tmp_path / "ck"))
    _tiny_sim(cuda, **run).run(1, checkpointer=ck)
    res = _tiny_sim(cuda, **run)
    assert res.run(3, checkpointer=ck, resume=True) == rows
    assert all(torch.equal(full.params[k], res.params[k])
               for k in full.params)


# the recurrences' backwards: (B, T, H) for wkv6 (rwkv6-3b's training
# microbatch, B = 2, the chunk edges, two whole chunks, B > 1 with a
# ragged last chunk) and (B, T, Di, N) for the selective
# scan (jamba's training microbatch, an odd Di and T with N = 7, N = 32,
# a Di past a block's 64 channels, a last chunk of one step)
WKV_BWD_CASES = [(1, 1024, 40), (2, 1024, 40), (1, 64, 40), (1, 65, 40),
                 (2, 129, 8), (1, 5, 3), (1, 128, 40), (3, 200, 4)]
SCAN_BWD_CASES = [(1, 1024, 8192, 16), (3, 77, 300, 7), (1, 200, 1024, 32),
                  (2, 130, 8200, 16), (1, 129, 1024, 16)]


def _wkv_bwd_args(b, t, h, dtype, w_dtype, device, with_ds, seed=0):
    """The forward kernel's operands (edge decays) and states, an fp32
    cotangent dy and, ``with_ds``, dsT."""
    from repro_torch.kernels.wkv6 import wkv6_fwd_cuda
    args = _wkv_inputs(b, t, h, dtype, w_dtype, device, seed=seed, edge=True)
    _, _, states = wkv6_fwd_cuda(*args)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(b, t, h, 64, generator=g).to(device)
    ds = torch.randn(b, h, 64, 64, generator=g).to(device) if with_ds else None
    return args, states, dy, ds


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("b,t,h", WKV_BWD_CASES)
def test_wkv6_bwd_kernel_matches_plain(cuda, b, t, h, dtype, w_dtype,
                                       with_ds):
    """dr, dk, dv, dw, du and ds0 against ``wkv6_bwd_ref`` on the same
    operands, with decays of exactly 0, 1e-31 and 1 - 2^-24: fp32 within
    1e-5 of each gradient's largest magnitude (sums in other orders),
    bf16 within 2^-7 (each gradient rounded once); bit-repeatable; one
    launch a call."""
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda
    args, states, dy, ds = _wkv_bwd_args(b, t, h, dtype, w_dtype, cuda,
                                         with_ds, seed=t + b)
    before = build.LAUNCHES["wkv6_bwd"]
    got = wkv6_bwd_cuda(*args, states, dy, ds)
    again = wkv6_bwd_cuda(*args, states, dy, ds)
    assert build.LAUNCHES["wkv6_bwd"] == before + 2
    want = ref.wkv6_bwd_ref(*args, dy, ds)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, x, w, y in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                             want, again):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        assert bool(torch.isfinite(x).all()), name
        assert _scaled_err(x.float(), w.float()) <= tol, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("operand", [0, 1, 2, 3, "dy"])
def test_wkv6_bwd_refuses_misaligned_operands(cuda, operand):
    """An operand 4 bytes off a 16-byte boundary (contiguous, a view one
    fp32 into its storage) raises, and nothing is launched: the kernel
    stages its rows with 16-byte asynchronous copies."""
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda
    args, states, dy, _ = _wkv_bwd_args(1, 65, 2, torch.float32,
                                        torch.float32, cuda, False)

    def shifted(x):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = y[1:].view(x.shape)
        y.copy_(x)
        return y

    if operand == "dy":
        dy = shifted(dy)
    else:
        args = list(args)
        args[operand] = shifted(args[operand])
    before = build.LAUNCHES["wkv6_bwd"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv6_bwd_cuda(*args, states, dy)
    assert build.LAUNCHES["wkv6_bwd"] == before


def _scan_bwd_args(b, t, di, n, dtype, device, with_dh, seed=0,
                   underflow=False):
    """The forward kernel's operands and saved states, an fp32 cotangent
    dy and, ``with_dh``, dhT; ``underflow``: every 5th step's dt at 50
    and every 3rd channel's a at -100, so exp(dt a) underflows to 0."""
    from repro_torch.kernels.selective_scan import selective_scan_fwd_cuda
    args = _scan_inputs(b, t, di, n, torch.float32, "cpu", seed)
    if underflow:
        args[1][:, ::5] = 50.0
        args[4][::3] = -100.0
    args = [z.to(dtype).to(device) if i < 4 else z.to(device)
            for i, z in enumerate(args)]
    _, _, states = selective_scan_fwd_cuda(*args)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(b, t, di, generator=g).to(device)
    dh = torch.randn(b, di, n, generator=g).to(device) if with_dh else None
    return args, states, dy, dh


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,di,n", SCAN_BWD_CASES)
def test_selective_scan_bwd_kernel_matches_plain(cuda, b, t, di, n, dtype,
                                                 underflow):
    """dx, ddt, dB, dC, da and dh0 against ``selective_scan_bwd_ref`` on
    the same operands (dhT given where the state underflows, not
    elsewhere): fp32 within 1e-5 of each gradient's largest magnitude
    (sums in other orders; the states rebuilt from the forward's, whose
    exp is the MUFU's), bf16 within 2^-7; bit-repeatable; one launch a
    call."""
    from repro_torch.kernels.selective_scan import selective_scan_bwd_cuda
    args, states, dy, dh = _scan_bwd_args(b, t, di, n, dtype, cuda,
                                          underflow, seed=t, underflow=
                                          underflow)
    before = build.LAUNCHES["selective_scan_bwd"]
    got = selective_scan_bwd_cuda(*args, states, dy, dh)
    again = selective_scan_bwd_cuda(*args, states, dy, dh)
    assert build.LAUNCHES["selective_scan_bwd"] == before + 2
    want = ref.selective_scan_bwd_ref(*args, dy, dh)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, x, w, y in zip(("dx", "ddt", "dB", "dC", "da", "dh0"), got,
                             want, again):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        assert bool(torch.isfinite(x).all()), name
        assert _scaled_err(x.float(), w.float()) <= tol, name
        assert torch.equal(x, y), name


def test_selective_scan_saves_leave_the_forward_bit_equal(cuda):
    """The forward with its states saved: y and hT bit-equal to the call
    without, and each saved state within 1e-5 of the plain scan's state
    after as many steps."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_cuda, selective_scan_fwd_cuda)
    args = _scan_inputs(2, 200, 300, 16, torch.bfloat16, cuda, seed=3)
    y, h_t = selective_scan_cuda(*args)
    y2, h_t2, states = selective_scan_fwd_cuda(*args)
    assert torch.equal(y, y2) and torch.equal(h_t, h_t2)
    assert states.shape == (2, 3, 300, 16)
    for m in range(3):
        steps = 64 * (m + 1)
        _, want = ref.selective_scan_ref(*(z[:, :steps] for z in args[:4]),
                                         *args[4:])
        assert _scaled_err(states[:, m], want) <= 1e-5


@pytest.mark.parametrize("op", ["wkv6", "selective_scan"])
def test_recurrence_autograd_runs_the_kernels(cuda, op):
    """With grad required, ``ops.wkv6`` and ``ops.selective_scan`` are
    their autograd Functions: one forward launch, the serving bits, and
    in backward one backward launch whose gradients are the kernel's bit
    for bit (the final state's cotangent given); under no_grad the call
    is the forward alone."""
    from repro_torch.kernels import selective_scan as ss, wkv6
    if op == "wkv6":
        args = _wkv_inputs(1, 130, 4, torch.bfloat16, torch.float32, cuda)
        fwd, bwd, call = wkv6.wkv6_fwd_cuda, wkv6.wkv6_bwd_cuda, ops.wkv6
    else:
        args = _scan_inputs(1, 130, 300, 16, torch.bfloat16, cuda)
        fwd = ss.selective_scan_fwd_cuda
        bwd, call = ss.selective_scan_bwd_cuda, ops.selective_scan
    y, s_t, states = fwd(*args)
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(y.shape, generator=g).to(args[0].dtype).to(cuda)
    ds = torch.randn(s_t.shape, generator=g).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in args]
    build.reset_launches()
    out, last = call(*leaves)
    assert build.LAUNCHES[op] == 1 and torch.equal(out.detach(),
                                                   y.to(out.dtype))
    torch.autograd.backward((out, last), (dy, ds))
    assert build.LAUNCHES[op + "_bwd"] == 1
    for x, w in zip(leaves, bwd(*args, states, dy.float(), ds)):
        assert torch.equal(x.grad, w)
    with torch.no_grad():
        out, _ = call(*leaves)
    assert out.grad_fn is None
    assert build.LAUNCHES[op] == 2 and build.LAUNCHES[op + "_bwd"] == 2


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b",
                                  "whisper-medium"])
def test_family_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                       arch):
    """One scaled-down train step (2 layers, B = 4, S = 64 in 2
    microbatches) of the ssm, hybrid and audio families on the card
    against the CPU from the same parameters and batch, the step the
    clipped gradient itself (lr 1, eps 1, no decay): loss, grad_norm and
    every parameter's update within 2^-5 of scale in bf16 (cuBLAS
    against the CPU's GEMMs); rwkv6 and jamba in fp32 within 1e-4 (the
    compute dtype monkeypatched): a bf16 router near-tie could send a
    token elsewhere on one side (ROADMAP C3), and rwkv6's updates are
    the noisiest in bf16 (its bonus u sums r k (v . dy) over every
    token): at d_model 256 the two sides' bf16 rounding moved one past
    2^-5 of its scale.  Launches: each recurrence's forward twice a
    layer and microbatch (the recompute), its backward once; whisper's
    2 x (encoder, self- and cross-attention)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import transformer
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    fp32 = arch != "whisper-medium"
    if fp32:
        monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    cfg = scaled_down(get_arch(arch))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                  / cfg.experts_per_token)
    shape = ShapeConfig("t", 64, 4, "train", grad_accum=2)
    step = make_train_step(cfg, shape, optim.OptConfig(
        lr=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0))
    p_dev = registry.init_params(torch.Generator(device=cuda).manual_seed(0),
                                 cfg)
    p_cpu, before = _to(p_dev, "cpu"), _to(p_dev, "cpu")
    batch = registry.make_concrete_batch(cfg, shape,
                                         torch.Generator().manual_seed(1),
                                         "train")
    build.reset_launches()
    p_dev, _, m_dev = step(p_dev, optim.adamw_init(p_dev), _to(batch, cuda))
    torch.cuda.synchronize()
    want = {"rwkv6-3b": {"wkv6": 8, "wkv6_bwd": 4},
            "jamba-v0.1-52b": {"selective_scan": 4, "selective_scan_bwd": 2,
                               "flash_attention": 4,
                               "flash_attention_bwd": 2},
            "whisper-medium": {"flash_attention": 24,
                               "flash_attention_bwd": 12}}[arch]
    assert {k: v for k, v in build.LAUNCHES.items() if v} == want
    p_cpu, _, m_cpu = step(p_cpu, optim.adamw_init(p_cpu), batch)
    tol = 1e-4 if fp32 else 2 ** -5
    for k in ("loss", "grad_norm"):
        assert abs(float(m_dev[k]) - float(m_cpu[k])) <= tol * abs(
            float(m_cpu[k])), k
    for d, c, p0 in zip(optim.tree_leaves(p_dev), optim.tree_leaves(p_cpu),
                        optim.tree_leaves(before)):
        scale = float((c - p0).abs().max())
        assert bool(((d.cpu() - c).abs() <= tol * scale
                     + 2 ** -22 * c.abs()).all())
