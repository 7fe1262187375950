"""The client mesh's last single-host paths (ROADMAP A11a) against the
reference, on the CPU: the seed-batched sharded prefix, the event
server's sharded pool (and its resume), the sweep on the mesh, and the
seed axis of ``probe_loss`` and ``fuzzy_eval``.

The reference's own sharded path cannot run on the installed JAX
(ROADMAP C1), so the port's 2 ranks are held against the reference's
single-device results and against the port's own single device.  One
module-scoped spawn of 2 gloo ranks (one intra-op thread each) runs
every mesh job in turn (``torch_mesh_pool_ranks.rank_jobs``); the
single-device runs it is compared with run here at one thread too, since
the CPU convolutions' sums depend on the thread count.

Tolerances: masks, counts, landing-tick columns, histograms and
``alive_at_done`` equal; ``t_done`` to 1e-4 relative
(``test_torch_async.py::test_churn_prefix_matches_reference``); the
probe's losses to 1e-4 relative and evaluations to 1e-3 on [0, 100]
against the reference (fp32 sums in another order, ROADMAP C3);
accuracy within 1e-5 and params within 1e-5 against one device (the
partial sums add in another order) and against the reference's event
server, whose first round aggregates nothing (its updates land at the
1.5-period tick), so both train round 1 from the same weights; a
resumed run and the sweep's CSV bit for bit.
"""
import functools
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fuzzy import FuzzyEvaluator
from repro.core.rules import build_rule_table as ref_rules
from repro.fl import pipeline as ref_pipeline
from repro.fl.async_server import EventDrivenServer as RefEventDrivenServer
from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.rules import build_rule_table
from repro_torch.fl.aggregation import (fedavg, fedavg_finish,
                                        fedavg_masked, fedavg_sums)
from repro_torch.fl.rounds import FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.fl.timing import staleness_weight
from repro_torch.kernels import ops, ref
from repro_torch.launch import fl_sim, sweep
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train.checkpoint import (RoundCheckpointer, load_state,
                                         save_state)
from test_torch_mesh import params_to_flat, reference_fields
from test_torch_round import _cfgs
from test_torch_sweep import _ref_tiny

import torch_mesh_pool_ranks as ranks
from torch_threads import (intra_op_threads,
                           torch_intra_op_threads)  # noqa: F401

K = 2
ROUNDS = 2
SEEDS = (0, 1)
# the event server of the card's round-driver phase: churn 0.2,
# weighted lambda 0.5, a 90 s cadence (1.5 round periods)
EVENT = dict(churn_rate=0.2, staleness="weighted", staleness_lambda=0.5,
             agg_cadence_s=90.0)
INT_KEYS = ("round", "n_selected", "n_aggregated", "n_straggler",
            "n_active", "stale_frac", "n_effective", "rounds_behind_hist",
            "state_bytes", "upload_bytes", "state_time_s", "comm_time_s")
MESH = f"clients={K}"




def _run(**kw):
    return RunConfig(overlap_rounds=False, **kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Every mesh job in one spawn of 2 ranks, from the reference's
    weights on its draws: round 0's seed-batched prefix of 2 seeds at
    churn 0.2; the event server for 2 rounds; the same run killed after
    round 0's snapshot and resumed by fresh simulations; the sweep on the
    mesh.  The reference's runs and the port's single-device ones run
    here while the ranks work."""
    tmp = tmp_path_factory.mktemp("pool")
    rcfg, cfg = _cfgs()
    ref = RefSimulation(rcfg, run=RefRunConfig(overlap_rounds=False,
                                               **EVENT))
    fields = {r: reference_fields(ref, r) for r in range(ROUNDS)}
    params = params_to_flat(ref.params)
    # the sweep's tiny profile, one simulation a seed: the prefix check's
    # reference and every seed's draws
    seed_refs = [RefSimulation(_ref_tiny("dcs", 9, "uniform", s),
                               run=RefRunConfig(**EVENT)) for s in SEEDS]
    draws = {s: {r: reference_fields(sim, r, perms=False)
                 for r in range(ROUNDS)} for s, sim in zip(SEEDS, seed_refs)}
    seed_cfgs = [ranks.tiny_cell("dcs", 9, "uniform", s) for s in SEEDS]
    ckdir = str(tmp / "ck")
    grid = (("dcs", "random"), (9,), ("uniform",))
    sweep_kw = dict(seeds=SEEDS, rounds=ROUNDS, cfg_fn=ranks.tiny_cell,
                    vmap_prefix=True, workers=1, device="cpu",
                    fields_fn=functools.partial(ranks.lookup_fields, draws))
    mesh_run = lambda **kw: _run(mesh=MESH, **EVENT, **kw)
    inject = dict(fields=fields, params=params)
    jobs = [
        ("prefix", ranks.prefix_seeds_rank,
         (seed_cfgs, RunConfig(mesh=MESH, **EVENT),
          [draws[s] for s in SEEDS],
          [params_to_flat(r.params) for r in seed_refs], 0), {}),
        ("event", fl_sim.sim_rank, (cfg, mesh_run(), ROUNDS), inject),
        ("killed", fl_sim.sim_rank,
         (cfg, mesh_run(checkpoint_dir=ckdir), 1), inject),
        ("resumed", fl_sim.sim_rank,
         (cfg, mesh_run(checkpoint_dir=ckdir, resume=True), ROUNDS),
         inject),
        ("sweep", sweep._sweep_rank, grid,
         dict(sweep_kw, runs=[RunConfig(mesh=MESH).resolved()],
              out_path=str(tmp / "mesh.csv"))),
    ]
    out = {}

    def ranks_run():
        try:
            out["res"] = spawn_ranks(ranks.rank_jobs, K, "cpu",
                                     args=(jobs,), threads=1,
                                     timeout=400.0, workdir=tmp)
        except BaseException as e:          # re-raised below
            out["err"] = e
    worker = threading.Thread(target=ranks_run)
    worker.start()
    try:
        ref_rows = RefEventDrivenServer(ref).run(ROUNDS)
        st = ref_pipeline.stack_statics([r.statics for r in seed_refs])
        ref_prefix = jax.device_get(ref_pipeline.selection_prefix_seeds(
            st, jax.tree.map(lambda *x: jnp.stack(x),
                             *[r.params for r in seed_refs]),
            jnp.int32(0), jnp.stack([r.key for r in seed_refs]),
            jnp.stack([r.net_key for r in seed_refs]),
            cfg=seed_refs[0].stage_cfg))
        with intra_op_threads(1):
            single = FLSimulation(cfg, run=_run(**EVENT), device="cpu",
                                  fields=fields.__getitem__)
            single.params = {k: torch.tensor(v) for k, v in params.items()}
            single_rows = single.driver().run(ROUNDS)
            single_csv = sweep.rows_to_csv(sweep.sweep(*grid, **sweep_kw))
    finally:
        worker.join()
    if "err" in out:
        raise out["err"]
    return dict(res=out["res"], single=single, single_rows=single_rows,
                ref=ref, ref_rows=ref_rows, ref_prefix=ref_prefix,
                snapshot=load_state(RoundCheckpointer(ckdir).path_for(0)),
                single_csv=single_csv, mesh_csv=(tmp / "mesh.csv").read_text())


def _params(rank, job):
    return {k[len(job) + len("/param."):]: v for k, v in rank.items()
            if k.startswith(f"{job}/param.")}


# -- (a) the kernels' seed axis -----------------------------------------------

def _probe_operands(seeds, s_rows=150, n=6):
    rng = np.random.default_rng(7)
    from repro_torch.configs.mnist_cnn import CONFIG
    from repro_torch.models.cnn import init_cnn
    params = [init_cnn(torch.Generator().manual_seed(i), CONFIG)
              for i in range(seeds)]
    seg = np.sort(rng.integers(0, n + 1, (seeds, s_rows))).astype(np.int32)
    counts = np.stack([np.bincount(sg, minlength=n + 1)[:n]
                       for sg in seg]).astype(np.int32)
    return ({k: torch.stack([p[k] for p in params]) for k in params[0]},
            torch.tensor(rng.normal(size=(seeds, s_rows, 28, 28, 1))
                         .astype(np.float32)),
            torch.tensor(rng.integers(0, 10, (seeds, s_rows))
                         .astype(np.int32)),
            torch.tensor(seg), torch.tensor(counts), n)


def test_probe_loss_seed_axis_is_single_launches_and_the_references():
    """``probe_loss`` with a leading axis of 3 seeds: each seed's row
    ``==`` a call on that seed alone, and within 1e-4 relative of the
    reference's ``probe_loss_ref`` (its oracle of ``probe_loss_pallas``)
    on the same operands."""
    params, images, labels, seg, counts, n = _probe_operands(3)
    got = ops.probe_loss(params, images, labels, seg, counts, n_clients=n)
    assert got.shape == (3, n)
    for i in range(3):
        one = {k: v[i] for k, v in params.items()}
        alone = ops.probe_loss(one, images[i], labels[i], seg[i], counts[i],
                               n_clients=n)
        assert torch.equal(got[i], alone)
        want = np.asarray(ref_kref.probe_loss_ref(
            jax.tree.map(jnp.asarray, params_to_numpy(one)),
            jnp.asarray(images[i].numpy()), jnp.asarray(labels[i].numpy()),
            jnp.asarray(seg[i].numpy()), jnp.asarray(counts[i].numpy()), n))
        np.testing.assert_allclose(alone.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("external", [False, True])
def test_fuzzy_eval_seed_axis_is_single_launches_and_the_references(
        external):
    """``fuzzy_eval`` on (3, P, 4) raw features with Eq. 8 over each
    seed's own rows, or over its row of external maxima: each seed ``==``
    a call on that seed alone, and within 1e-3 on [0, 100] of the
    reference's Mamdani evaluator on that seed's scaled rows."""
    rng = np.random.default_rng(11)
    x = (rng.uniform(0, 1, (3, 37, 4))
         * np.array([4500, 3e6, 1.0, 2.5])).astype(np.float32)
    ev = FuzzyEvaluator()
    mam = [np.asarray(a, np.float32) for a in (ev.cfg.means, ev.cfg.sigmas,
                                               ev.level_centers)]
    t = [torch.tensor(a) for a in mam]
    table, levels = build_rule_table()
    colmax = (x.max(axis=1) * rng.uniform(0.7, 1.3, (3, 4))).astype(
        np.float32) if external else None
    cm = None if colmax is None else torch.tensor(colmax)
    got = ops.fuzzy_eval(torch.tensor(x), t[0], t[1], table, levels, t[2],
                         normalize=True, col_maxima=cm)
    assert got.shape == (3, 37)
    for i in range(3):
        alone = ops.fuzzy_eval(torch.tensor(x[i]), t[0], t[1], table,
                               levels, t[2], normalize=True,
                               col_maxima=None if cm is None else cm[i])
        assert torch.equal(got[i], alone)
        rt, rl = ref_rules()
        want = ref_ops.fuzzy_eval(
            jnp.asarray(x[i]), *(jnp.asarray(a) for a in mam[:2]), rt, rl,
            jnp.asarray(mam[2]), impl="jnp", normalize=True,
            col_maxima=None if colmax is None else jnp.asarray(colmax[i]))
        np.testing.assert_allclose(alone.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-3)
    plain = ref.fuzzy_eval_ref(torch.tensor(x), t[0], t[1],
                               torch.tensor(table), torch.tensor(levels),
                               t[2], normalize=True, col_maxima=cm)
    assert torch.equal(plain, got)


# -- (b) the seed-batched sharded prefix --------------------------------------

def test_sharded_seed_prefix_matches_reference(pool):
    """Round 0 of 2 seeds at churn 0.2 on 2 ranks (one ``probe_loss`` and
    one ``fuzzy_eval`` call for both seeds) against the reference's
    ``selection_prefix_seeds`` on its draws: masks, survivors,
    ``alive_at_done`` and every count equal, ``t_done`` to 1e-4
    relative, evaluations to 1e-3."""
    res, want = pool["res"], pool["ref_prefix"]
    n = want["mask"].shape[1]
    got = {key: np.concatenate([r[f"prefix/{key}"] for r in res],
                               axis=1)[:, :n]
           for key in ("mask", "survivors", "alive_at_done", "t_done",
                       "evals")}
    for key in ("mask", "survivors", "alive_at_done"):
        np.testing.assert_array_equal(got[key].astype(np.int64),
                                      np.asarray(want[key]).astype(np.int64))
    np.testing.assert_allclose(got["t_done"], want["t_done"], rtol=1e-4)
    np.testing.assert_allclose(got["evals"], want["evals"], rtol=0,
                               atol=1e-3)
    for key in ("n_selected", "n_straggler", "n_survivor", "n_active"):
        for r in res:
            np.testing.assert_array_equal(r[f"prefix/{key}"],
                                          np.asarray(want[key]))
    assert int(np.asarray(want["n_active"]).min()) < n   # churn bites
    assert got["mask"].sum() > 0


# -- (c) the event server's sharded pool --------------------------------------

def test_sharded_event_pool_matches_single_device(pool):
    """2 rounds of the event server on 2 ranks against the port's single
    device on the same draws and weights: every rank's rows and params
    the same, the integer and async columns equal, accuracy within 1e-5
    and params within 1e-5."""
    res = pool["res"]
    rows = res[0]["event/rows"]
    assert rows == res[1]["event/rows"]
    mine = _params(res[0], "event")
    for key, v in mine.items():
        np.testing.assert_array_equal(_params(res[1], "event")[key], v)
    for got, want in zip(rows, pool["single_rows"]):
        for key in INT_KEYS:
            assert got[key] == want[key], (key, got, want)
        assert abs(got["accuracy"] - want["accuracy"]) <= 1e-5
    for key, v in pool["single"].params.items():
        np.testing.assert_allclose(mine[key], v.numpy(), rtol=0, atol=1e-5)
    assert sum(r["n_aggregated"] for r in rows) > 0
    assert any(r["stale_frac"] > 0 for r in rows)


def test_sharded_event_pool_matches_reference(pool):
    """The same 2 rounds against the reference's event server: the
    integer and async columns equal, accuracy within 1e-5 and the params
    within 1e-5 (round 0 aggregates nothing, so both train round 1 from
    the reference's weights)."""
    rows = pool["res"][0]["event/rows"]
    assert pool["ref_rows"][0]["n_aggregated"] == 0
    for got, want in zip(rows, pool["ref_rows"]):
        for key in INT_KEYS:
            assert got[key] == want[key], (key, got, want)
        assert abs(got["accuracy"] - want["accuracy"]) <= 1e-5
    theirs = params_from_jax(jax.device_get(pool["ref"].params))
    for key, v in _params(pool["res"][0], "event").items():
        np.testing.assert_allclose(v, theirs[key].numpy(), rtol=0,
                                   atol=1e-5)


def test_sharded_event_pool_resumes_bit_for_bit(pool):
    """Killed after round 0's snapshot, which holds the pool's pending
    partial sums (``num``, ``den``) for the 1.5-period tick, and resumed
    by fresh simulations on both ranks: rows and params equal to the
    uninterrupted run's."""
    res = pool["res"]
    state, extra = pool["snapshot"]
    pending = [it for items in state["pending"].values() for it in items]
    assert pending and all({"num", "den"} <= set(it) for it in pending)
    assert extra["next_round"] == 1
    for r in res:
        assert r["resumed/rows"] == r["event/rows"]
        want = _params(r, "event")
        for key, v in _params(r, "resumed").items():
            np.testing.assert_array_equal(v, want[key])


def test_a_lone_restored_mesh_tick_divides_as_the_uninterrupted_one(
        tmp_path):
    """A landing tick whose only entry is a stale bucket of mixed-size
    clients, restored from a snapshot: its ``den`` (fp64 from
    ``fedavg_sums``, here no fp32 number) comes back float64, and the
    tick's FedAvg, anchor row included, gives the uninterrupted server's
    bits.  The mesh's tick path reads the mesh only to take the
    partial-sum branch, so a stand-in drives it on one process."""
    _, cfg = _cfgs()
    servers = [FLSimulation(cfg, run=_run(**EVENT), device="cpu").driver()
               for _ in range(2)]
    rng = np.random.default_rng(3)
    params = servers[0].sim.params
    stack = {k: v[None] + torch.tensor(rng.normal(
        scale=1e-2, size=(3, *v.shape)).astype(np.float32))
        for k, v in params.items()}
    s = staleness_weight(EVENT["staleness_lambda"], 1)
    w = np.array([1117, 40, 233], np.float32) * np.float32(s)
    num, den = fedavg_sums(stack, torch.tensor(w))
    assert den.dtype == torch.float64
    assert float(np.float32(den.item())) != den.item()
    as_fp32 = fedavg_finish(num, den.float(), params)
    assert any(not torch.equal(v, fedavg_finish(num, den, params)[k])
               for k, v in as_fp32.items())      # the dtype shows
    servers[0]._pending = {1: [{
        "src": 0, "num": num, "den": den,
        "anchor": float(float(w.sum()) / s * (1.0 - s)), "n": 3,
        "delay": 1, "scale": float(s)}]}
    save_state(str(tmp_path / "snap"), servers[0].capture_state())
    servers[1].restore_state(load_state(str(tmp_path / "snap"))[0])
    restored = servers[1]._pending[1][0]
    assert restored["den"].dtype == torch.float64
    assert torch.equal(restored["den"], den)
    for server in servers:
        server.sim.mesh = SimpleNamespace(size=K)
        server._stats[1] = {"n_agg": 0, "n_stale": 0, "eff": 0.0,
                            "hist": [0] * 4}
        server._process_due_ticks(1)
        assert not server._pending
    for key, v in servers[0].sim.params.items():
        assert torch.equal(servers[1].sim.params[key], v), key
        assert not torch.equal(params[key], v), key
    assert servers[0]._stats == servers[1]._stats

# -- (e) the sweep on the mesh ------------------------------------------------

def test_mesh_sweep_writes_the_single_device_csv(pool):
    """``sweep`` on 2 ranks (the body of ``--mesh clients=2``: rank 0
    writes the CSV), 2 seeds x (dcs, random) x 2 rounds at the
    reference's tiny sweep profile on its draws: the CSV byte-equal to
    the single-device sweep's, and rank 1 wrote nothing else."""
    assert pool["mesh_csv"] == pool["single_csv"]
    assert pool["res"][1]["sweep/n_rows"] == pool["res"][0]["sweep/n_rows"] \
        == 2 * len(SEEDS) * ROUNDS


def test_fedavg_does_not_depend_on_how_the_cohort_is_split():
    """Eq. 2's fp32 average is the same bits whether the cohort's models
    come as one padded stack (the batched engine), a list (the loop
    engine) or slices whose fp64 partial sums are added (a mesh's ranks,
    capacity groups): the sums accumulate in fp64."""
    rng = np.random.default_rng(5)
    models = [{"a": torch.tensor(rng.normal(size=(64, 33)).astype(
        np.float32)), "b": torch.tensor(rng.normal(size=(7,)).astype(
            np.float32))} for _ in range(9)]
    w = rng.integers(1, 4500, 9).astype(np.float32)
    stacked = {k: torch.stack([m[k] for m in models]) for k in models[0]}
    padded = {k: torch.cat([v, v[:3]]) for k, v in stacked.items()}
    want = fedavg_masked(padded, torch.tensor(np.concatenate(
        [w, np.zeros(3, np.float32)])))
    parts = [fedavg_sums({k: v[lo:hi] for k, v in stacked.items()},
                         torch.tensor(w[lo:hi]))
             for lo, hi in ((0, 2), (2, 7), (7, 9))]
    num = {k: sum(p[0][k] for p in parts) for k in stacked}
    split = fedavg_finish(num, sum(p[1] for p in parts), stacked)
    for got in (fedavg(models, w.tolist()), split,
                fedavg_masked(stacked, torch.tensor(w))):
        for k in want:
            assert torch.equal(got[k], want[k]), k
