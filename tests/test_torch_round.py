"""One federated round of the port against the JAX reference.

Both packages start from the same parameters (``convert.py``) and the
port is fed the reference's random draws (channel and upload shadows,
Reno loss uniforms, the uniform scheme's pick, the per-epoch training
permutations) through ``RoundFields``.  Floats are held to stated
tolerances; election masks must be equal given the reference's
positions and evaluations.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as REF_CNN
from repro.fl import client as ref_client
from repro.fl import network as ref_net
from repro.fl import pipeline as ref_pipeline
from repro.fl.mobility import MobilityConfig as RefMobility
from repro.fl.partition import PartitionConfig as RefPartition
from repro.fl.rounds import FLSimConfig as RefSimConfig
from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.models.cnn import init_cnn as ref_init_cnn
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl import client, pipeline
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import RunConfig
from torch_threads import torch_intra_op_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N = 10


def _cfgs(scheme="dcs", seed=0, n=N, distribution="uniform"):
    """The reference's 10-client parity profile (tests/test_probe_fuzzy.py)
    in both packages, for a fleet of ``n``."""
    kw = dict(scheme=scheme, n_rounds=2, local_epochs=1,
              samples_per_class=260, probe_samples=64, seed=seed)
    part = dict(n_clients=n, big_clients=3, big_quantity=120,
                small_quantity=40, classes_per_client=9, seed=seed)
    mob = dict(n_vehicles=n, seed=seed, distribution=distribution)
    return (RefSimConfig(partition=RefPartition(**part),
                         mobility=RefMobility(**mob), **kw),
            FLSimConfig(partition=PartitionConfig(**part),
                        mobility=MobilityConfig(**mob), **kw))


def reference_fields(sim: RefSimulation, rnd: int) -> pipeline.RoundFields:
    """Round ``rnd``'s draws exactly as the reference makes them inside
    its prefix (``fl/pipeline.py::_prefix``) and trainer
    (``fl/client.py::_local_train_batch``)."""
    n, cfg = sim.n, sim.cfg
    k_sel = jax.random.fold_in(sim.key, rnd)
    k_pred, k_upload = jax.random.split(jax.random.fold_in(sim.net_key, rnd))
    keys = sim._round_keys(rnd)
    perms = []
    for i in range(n):
        cap = sim.groups[sim._slot[i, 0]].cap
        ek = jax.random.split(keys[i], cfg.local_epochs)
        perms.append(torch.tensor(np.stack(
            [np.asarray(jax.random.permutation(ek[e], cap))
             for e in range(cfg.local_epochs)])).long())
    k = min(cfg.n_clients_central, n)
    t = lambda a: torch.tensor(np.asarray(a))
    return pipeline.RoundFields(
        channel_shadow=t(ref_net.pinned_channel_shadow(n)),
        loss_u=t(ref_net.cwnd_loss_fields(k_pred, n)),
        upload_shadow=t(jax.random.normal(k_upload, (n,))),
        random_idx=t(jax.random.choice(k_sel, n, (k,), replace=False)),
        perms=perms)


def _eval_margin(evals, e_tau):
    """Smallest gap between two evaluations or to E_tau — how close the
    round came to a tie that fp32 rounding could flip."""
    e = np.sort(np.asarray(evals, np.float64))
    gaps = np.diff(e)
    return float(min(np.abs(e - e_tau).min(),
                     gaps.min() if gaps.size else np.inf))


_PAIRS = {}


def _pair(fused: bool):
    """A reference simulation and the port's (CPU) on the same config,
    fed the reference's draws; built once per module and mode."""
    if fused not in _PAIRS:
        rcfg, cfg = _cfgs()
        ref = RefSimulation(rcfg, run=RefRunConfig(fused_probe=fused,
                                                   overlap_rounds=False))
        port = FLSimulation(cfg, run=RunConfig(fused_probe=fused),
                            device="cpu",
                            fields=lambda r: reference_fields(ref, r))
        _PAIRS[fused] = (ref, port)
    return _PAIRS[fused]


@pytest.mark.parametrize("fused", [True, False])
def test_statics_are_the_references(fused):
    ref, port = _pair(fused)
    st, rst = port.statics, ref.statics
    for f in ("x0", "speeds", "jitter_phase", "slowdown", "n_valid",
              "probe_images", "probe_labels", "probe_seg", "probe_counts",
              "means", "sigmas", "level_centers"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(rst, f)), err_msg=f)


@pytest.mark.parametrize("scheme", ["dcs", "ccs-fuzzy", "random"])
@pytest.mark.parametrize("fused", [True, False])
def test_selection_prefix_matches_reference(fused, scheme):
    """Positions/features to fp32 rounding (1e-4), evaluations to 1e-3 on the
    [0, 100] scale; masks equal given the reference's evaluations, and
    end to end unless a near-tie (ROADMAP C3) — the margin is printed."""
    ref, port = _pair(fused)
    port.params = params_from_jax(jax.device_get(ref.params))
    rcfg = dataclasses.replace(ref.stage_cfg, scheme=scheme)
    cfg = dataclasses.replace(port.stage_cfg, scheme=scheme)
    for rnd in (0, 3):
        want = jax.device_get(ref_pipeline.selection_prefix(
            ref.statics, ref.params, jnp.int32(rnd), ref.key, ref.net_key,
            cfg=rcfg))
        fields = reference_fields(ref, rnd)
        got = pipeline.selection_prefix(port.statics, port.params, rnd,
                                        fields, cfg=cfg)
        np.testing.assert_allclose(got["pos"].numpy(), want["pos"],
                                   rtol=0, atol=1e-3)
        # TA is 10**x of a position-derived exponent: an ulp of fp32
        # cos/pow in either library moves it ~1e-5 relative
        np.testing.assert_allclose(got["feats"].numpy(), want["feats"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["evals"].numpy(), want["evals"],
                                   rtol=0, atol=1e-3)
        # the election alone, on the reference's positions and evals
        mask = pipeline.select(cfg, torch.tensor(want["pos"]),
                               torch.tensor(want["evals"]), fields)
        np.testing.assert_array_equal(mask.numpy(), want["mask"])
        margin = _eval_margin(want["evals"], cfg.e_tau)
        print(f"[{scheme} fused={fused} round {rnd}] smallest eval "
              f"margin {margin:.3g}")
        np.testing.assert_array_equal(
            got["mask"].numpy(), want["mask"],
            err_msg=f"end-to-end masks differ; smallest margin {margin}")
        np.testing.assert_array_equal(got["survivors"].numpy(),
                                      want["survivors"])
        assert int(got["n_straggler"]) == int(want["n_straggler"])


def test_local_train_batch_matches_reference():
    """Two epochs of local SGD from shared params on the reference's
    permutations: params agree to 1e-4 (fp32 gradients summed in
    another order)."""
    rng = np.random.default_rng(5)
    c, cap, epochs = 3, 40, 2
    images = rng.normal(size=(c, cap, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (c, cap)).astype(np.int32)
    n_valid = np.array([40, 23, 7], np.int32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i)
                    )(jnp.arange(c))
    ref_params = _ref_init(2)
    want, want_loss = ref_client.local_train_batch(
        ref_params, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(n_valid), keys, epochs=epochs, batch_size=20,
        steps_per_epoch=2, lr=0.05)
    ek = jax.vmap(lambda k: jax.random.split(k, epochs))(keys)
    perms = torch.tensor(np.stack([
        np.stack([np.asarray(jax.random.permutation(ek[i, e], cap))
                  for i in range(c)]) for e in range(epochs)])).long()
    got, loss = client.local_train_batch(
        params_from_jax(ref_params), torch.tensor(images),
        torch.tensor(labels), torch.tensor(n_valid), perms, epochs=epochs,
        batch_size=20, steps_per_epoch=2, lr=0.05)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-4)
    want = jax.device_get(want)
    for i in range(c):
        mine = params_to_numpy({k: v[i] for k, v in got.items()})
        for name in mine:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    mine[name][leaf], want[name][leaf][i], rtol=1e-4,
                    atol=1e-5, err_msg=f"client {i} {name}.{leaf}")


def _ref_init(seed):
    return jax.device_get(ref_init_cnn(jax.random.PRNGKey(seed), REF_CNN))


def _check_round(ref, port, rnd):
    """One whole round in both packages: integer row fields and masks
    equal, accuracy within 0.01 (four of the 390 test images).  Returns
    the two rows (reference, port)."""
    want, got = ref.run_round(rnd), port.run_round(rnd)
    for key in ("round", "n_selected", "n_aggregated", "n_straggler",
                "n_active"):
        assert got[key] == want[key], (rnd, key, got, want)
    np.testing.assert_array_equal(port.last_mask, ref.last_mask)
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.01
    assert abs(got["mean_eval_selected"]
               - want["mean_eval_selected"]) <= 1e-3
    return want, got


@pytest.mark.parametrize("fused", [True, False])
def test_two_rounds_match_reference(fused):
    """Two whole rounds from the same params on the reference's draws
    (``_check_round``).  Then a third round from params re-synced to
    the reference's: the global params agree to 1e-5.  (Carried across
    rounds, the 1e-7 gap of one round grows to ~5e-4: SGD at lr 0.05
    amplifies it through the ReLU kinks, so the params are compared
    per round.)"""
    ref, port = _pair(fused)
    ref.params = jax.tree.map(jnp.asarray, _ref_init(0))
    port.params = params_from_jax(_ref_init(0))

    _check_round(ref, port, 0)
    _check_round(ref, port, 1)
    port.params = params_from_jax(jax.device_get(ref.params))
    _check_round(ref, port, 2)
    mine, theirs = params_to_numpy(port.params), jax.device_get(ref.params)
    for name in mine:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(mine[name][leaf],
                                       np.asarray(theirs[name][leaf]),
                                       rtol=0, atol=1e-5)


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.fl.rounds, repro_torch.launch.fl_sim\n"
            "import repro_torch.kernels.probe_fuzzy, "
            "repro_torch.kernels.fuzzy_eval, "
            "repro_torch.kernels.neighbor_elect, "
            "repro_torch.kernels.windowed_counts, repro_torch.core.elect, "
            "repro_torch.convert, repro_torch.kernels.wkv6, "
            "repro_torch.launch.serve, repro_torch.serve.engine, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.models.attention, "
            "repro_torch.kernels.selective_scan, repro_torch.models.mamba, "
            "repro_torch.models.moe, repro_torch.configs.jamba_v0_1_52b, "
            "repro_torch.launch.mesh, repro_torch.kernels.probe_loss, "
            "repro_torch.ioutil, repro_torch.core.overhead, "
            "repro_torch.launch.sweep, repro_torch.core.selection, "
            "repro_torch.fl.schemes, repro_torch.fl.network, "
            "repro_torch.fl.async_server, repro_torch.train.checkpoint, "
            "repro_torch.launch.faults\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    pat = ("import jax", "from jax", "import repro\n", "import repro.",
           "from repro ", "from repro.")
    for path in [REPO / "chip_smoke.py",
                 *sorted((REPO / "src" / "repro_torch").rglob("*.py"))]:
        text = path.read_text()
        for p in pat:
            assert p not in text, f"{path}: {p!r}"


def test_cli_without_cuda_raises():
    from repro_torch.launch import fl_sim
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fl_sim.main(["--rounds", "1"])


@pytest.mark.parametrize("kw", [
    dict(mesh="clients=4", multihost=2),
    dict(multihost=2)])
def test_unported_knobs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A11b"):
        RunConfig(**kw).resolved()


def test_mesh_with_churn_resolves_to_the_event_server():
    """The event server's sharded pool is ported (ROADMAP A11a): on the
    client mesh, churn, weighted staleness and a cadence resolve as on
    one device, as the reference's."""
    for kw in (dict(churn_rate=0.2), dict(staleness="weighted"),
               dict(agg_cadence_s=90.0)):
        run = RunConfig(mesh="clients=2", **kw).resolved()
        assert (run.server, run.mesh) == ("event", "clients=2")


# (RunConfig fields shared by both packages; the port adds multihost
# and elect_capacity)
def _shared(port_run, ref_run):
    names = {f.name for f in dataclasses.fields(ref_run)}
    names &= {f.name for f in dataclasses.fields(port_run)}
    return ({n: getattr(port_run, n) for n in names},
            {n: getattr(ref_run, n) for n in names})


# the knobs that keep the synchronous server
_SYNC_KNOBS = {"overlap_rounds", "checkpoint_dir", "checkpoint_every",
               "resume"}


@pytest.mark.parametrize("kw", [
    dict(server="event"), dict(churn_rate=0.3), dict(staleness="weighted"),
    dict(agg_cadence_s=10.0), dict(overlap_rounds=True),
    dict(checkpoint_dir="ckpt"),
    dict(checkpoint_dir="ckpt", checkpoint_every=3, resume=True)])
def test_async_and_overlap_knobs_resolve(kw):
    """The event server's, the round-ahead schedule's and the
    checkpoints' knobs resolve as the reference's (the same server
    promotion), and the churn rate reaches the prefix's
    ``StageConfig``."""
    mine, theirs = RunConfig(**kw).resolved(), RefRunConfig(**kw).resolved()
    got, want = _shared(mine, theirs)
    assert got == want
    assert mine.server == ("sync" if set(kw) <= _SYNC_KNOBS else "event")
    rcfg, cfg = _cfgs()
    assert (mine.to_stage_config(cfg, n_clients=N).churn_rate
            == theirs.to_stage_config(rcfg, n_clients=N).churn_rate
            == kw.get("churn_rate", 0.0))


@pytest.mark.parametrize("kw", [
    dict(server="async"), dict(staleness="sometimes"),
    dict(churn_rate=1.5), dict(churn_rate=-0.1),
    dict(staleness_lambda=-1.0), dict(agg_cadence_s=0.0),
    dict(staleness="weighted", engine="loop"), dict(resume=True),
    dict(checkpoint_dir="ckpt", checkpoint_every=0)])
def test_runconfig_validates_as_the_reference(kw):
    """Each of the reference's ``resolved()`` rules raises ``ValueError``
    in both packages."""
    with pytest.raises(ValueError):
        RefRunConfig(**kw).resolved()
    with pytest.raises(ValueError):
        RunConfig(**kw).resolved()


@pytest.mark.parametrize("n,want", [(30, "gather"), (511, "gather"),
                                    (512, "windowed"), (4096, "windowed")])
def test_auto_election_resolves_by_fleet_size(n, want):
    """``elect="auto"`` resolves as the reference's does: windowed from
    512 vehicles on; an explicit choice is kept at any size."""
    rcfg, cfg = _cfgs()
    assert RunConfig().to_stage_config(cfg, n_clients=n).elect == want
    assert RefRunConfig().to_stage_config(rcfg, n_clients=n).elect == want
    for elect in ("gather", "windowed"):
        sc = RunConfig(elect=elect, elect_window=7).to_stage_config(
            cfg, n_clients=n)
        assert (sc.elect, sc.elect_window) == (elect, 7)
    with pytest.raises(ValueError, match="elect_window"):
        RunConfig(elect_window=-1).resolved()


def _windowed_pair(n, distribution="uniform", elect_window=0):
    """Both packages on ``_cfgs(n=n)`` with the windowed election forced,
    from the same params, the port fed the reference's draws."""
    rcfg, cfg = _cfgs(n=n, distribution=distribution)
    ref = RefSimulation(rcfg, run=RefRunConfig(
        elect="windowed", elect_window=elect_window, overlap_rounds=False))
    port = FLSimulation(cfg, run=RunConfig(elect="windowed",
                                           elect_window=elect_window),
                        device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    ref.params = jax.tree.map(jnp.asarray, _ref_init(0))
    port.params = params_from_jax(_ref_init(0))
    return ref, port


def _overflow(ref, port, rnd):
    want = jax.device_get(ref.selection_state(rnd))
    got = port.selection_state(rnd)
    assert got["elect_overflow"].dtype == torch.int32
    assert got["elect_overflow"].shape == ()
    return int(got["elect_overflow"]), int(want["elect_overflow"])


@pytest.mark.parametrize("n", [N, 30])
def test_windowed_rounds_match_reference(n):
    """``elect="windowed"`` at the auto window: no overflow in either
    package, and two rounds match the reference (``_check_round``)."""
    ref, port = _windowed_pair(n)
    assert port.stage_cfg.elect == "windowed"
    for rnd in (0, 1):
        assert _overflow(ref, port, rnd) == (0, 0)
        _check_round(ref, port, rnd)


@pytest.mark.parametrize("n", [N, 30])
def test_windowed_overflow_falls_back_to_gather(n):
    """A 2-rank window on the crowded 'extreme' fleet overflows in both
    packages; the round then runs on the dense election's masks, equal
    to the reference's and to the port's own ``elect="gather"`` round."""
    ref, port = _windowed_pair(n, distribution="extreme", elect_window=2)
    assert _overflow(ref, port, 0) == (1, 1)
    _check_round(ref, port, 0)
    _, cfg = _cfgs(n=n, distribution="extreme")
    gather = FLSimulation(cfg, run=RunConfig(elect="gather"), device="cpu",
                          fields=lambda r: reference_fields(ref, r))
    gather.params = params_from_jax(_ref_init(0))
    gather.run_round(0)
    np.testing.assert_array_equal(port.last_mask, gather.last_mask)


def _counting(monkeypatch, obj, name, calls):
    fn = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)
    monkeypatch.setattr(obj, name, counted)


@pytest.mark.parametrize("distribution,overflows", [("uniform", False),
                                                    ("extreme", True)])
def test_overflow_rerun_reuses_the_rounds_fields(monkeypatch, distribution,
                                                 overflows):
    """A round draws its fields once.  Without overflow it runs the
    windowed counts once and never the dense election; on overflow the
    prefix re-runs on the same ``RoundFields`` object through the dense
    election."""
    from repro_torch.kernels import ops
    _, cfg = _cfgs(distribution=distribution)
    sim = FLSimulation(cfg, run=RunConfig(
        elect="windowed", elect_window=0 if not overflows else 2),
        device="cpu")
    draws, prefixes, dense, counts = [], [], [], []
    _counting(monkeypatch, sim, "round_fields", draws)
    _counting(monkeypatch, pipeline, "selection_prefix", prefixes)
    _counting(monkeypatch, ops, "neighbor_elect", dense)
    _counting(monkeypatch, ops, "windowed_counts", counts)
    sim.run_round(0)
    assert len(draws) == 1 and len(counts) == 1
    if not overflows:
        assert len(prefixes) == 1 and dense == []
    else:
        assert len(prefixes) == 2 and len(dense) == 1
        (first, kw0), (rerun, kw1) = prefixes
        assert rerun[3] is first[3]                    # the same fields
        assert (kw0["cfg"].elect, kw1["cfg"].elect) == ("windowed",
                                                        "gather")
