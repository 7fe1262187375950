"""The port's multi-seed sweep (``repro_torch.launch.sweep``) against the
reference's (``repro.launch.sweep``), at ``tests/test_sweep.py``'s tiny
profile (10 clients).

Host code (the CSV schema, its formats, the aggregation, the parse) is
held with ``==`` and byte for byte.  The seed-batched prefix is held
bit-equal to single-seed prefixes in the port, and to the reference's
``selection_prefix_seeds`` on the reference's draws: masks and
survivors equal, features to 1e-4 relative, evaluations to 1e-3 on
[0, 100] (fp32 sums in another order, ROADMAP C3).  The whole sweep,
started from the reference's weights on the reference's draws: integer
and comm columns equal, accuracy within 0.01 (four of the 390 test
images, as ``test_torch_round.py::_check_round``) and the mean
evaluation within 1e-3.
"""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.fl import pipeline as ref_pipeline
from repro.fl.mobility import MobilityConfig as RefMobility
from repro.fl.partition import PartitionConfig as RefPartition
from repro.fl.partition import partition as ref_partition
from repro.fl.rounds import FLSimConfig as RefSimConfig
from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.launch import sweep as ref_sweep
from repro_torch.convert import params_from_jax
from repro_torch.core.rules import build_rule_table
from repro_torch.core.selection import ccs_fuzzy_select, ccs_random_select
from repro_torch.data import synthetic as port_synthetic
from repro_torch.fl import pipeline
from repro_torch.fl import rounds as port_rounds
from repro_torch.fl.mobility import MobilityConfig
from repro_torch.fl.partition import PartitionConfig
from repro_torch.fl.partition import partition as port_partition
from repro_torch.fl.rounds import FLSimConfig, FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.kernels import ref
from repro_torch.launch import sweep
from test_torch_round import _eval_margin, _ref_init, reference_fields
from torch_threads import torch_intra_op_threads  # noqa: F401

SCHEMES = ("dcs", "random")
SEEDS = (0, 1)
ROUNDS = 2
INT_COLS = ("round", "seed", "classes_per_client", "n_selected",
            "n_aggregated", "n_straggler", "n_active")
EXACT_COLS = ("scheme", "distribution", "churn_rate", "staleness_lambda",
              "agg_cadence_s", "stale_frac", "n_effective",
              "rounds_behind_hist", "state_bytes", "upload_bytes",
              "state_time_s", "comm_time_s")


def _tiny_kw(classes, dist, seed):
    return (dict(local_epochs=1, samples_per_class=260, probe_samples=64,
                 seed=seed),
            dict(n_clients=10, big_clients=3, big_quantity=120,
                 small_quantity=40, classes_per_client=classes, seed=seed),
            dict(n_vehicles=10, distribution=dist, seed=seed))


def _tiny(scheme, classes, dist, seed):
    """``tests/test_sweep.py::_tiny`` in the port."""
    kw, part, mob = _tiny_kw(classes, dist, seed)
    return FLSimConfig(scheme=scheme, partition=PartitionConfig(**part),
                       mobility=MobilityConfig(**mob), **kw)


def _ref_tiny(scheme, classes, dist, seed):
    kw, part, mob = _tiny_kw(classes, dist, seed)
    return RefSimConfig(scheme=scheme, partition=RefPartition(**part),
                        mobility=RefMobility(**mob), **kw)


@pytest.fixture(scope="module")
def ref_run():
    """The reference's 2-seed x (dcs, random) x 2-round sweep, and one
    reference simulation per seed for its draws."""
    rows = ref_sweep.sweep(SCHEMES, (9,), ("uniform",), seeds=SEEDS,
                           rounds=ROUNDS, cfg_fn=_ref_tiny)
    sims = {s: RefSimulation(_ref_tiny("dcs", 9, "uniform", s))
            for s in SEEDS}
    return rows, ref_sweep.rows_to_csv(rows), sims


def _port_sweep(sims=None, **kw):
    fields_fn = None
    if sims is not None:
        fields_fn = lambda seed: (lambda r: reference_fields(sims[seed], r))
    return sweep.sweep(SCHEMES, (9,), ("uniform",), seeds=SEEDS,
                       rounds=ROUNDS, cfg_fn=_tiny, device="cpu",
                       fields_fn=fields_fn, **kw)


def _reference_weights(monkeypatch):
    """Port simulations start from the reference's weights of their
    seed (``init_cnn(PRNGKey(seed))``)."""
    def init(gen, cfg, device):
        return {k: v.to(device)
                for k, v in params_from_jax(_ref_init(gen.initial_seed()))
                .items()}
    monkeypatch.setattr(port_rounds, "init_cnn", init)


def test_constants_are_the_references():
    assert sweep.SCHEMES == ref_sweep.SCHEMES
    assert sweep.CSV_COLUMNS == ref_sweep.CSV_COLUMNS
    assert sweep._FMT == ref_sweep._FMT
    assert sweep._GROUP_KEY == ref_sweep._GROUP_KEY
    assert sweep._INT_COLS == ref_sweep._INT_COLS
    assert sweep._STR_COLS == ref_sweep._STR_COLS


@pytest.mark.parametrize("scheme,classes,dist,seed", [
    ("dcs", 9, "uniform", 0), ("random", 2, "extreme", 3),
    ("ccs-fuzzy", 6, "uniform", 1)])
def test_cell_configs_are_the_references(scheme, classes, dist, seed):
    for mine_fn, theirs_fn in ((sweep.fast_cell_config,
                                ref_sweep.fast_cell_config),
                               (sweep.paper_cell_config,
                                ref_sweep.paper_cell_config)):
        mine = dataclasses.asdict(mine_fn(scheme, classes, dist, seed))
        theirs = dataclasses.asdict(theirs_fn(scheme, classes, dist, seed))
        for key, value in mine.items():
            assert theirs[key] == value, key


@functools.lru_cache(maxsize=None)
def _dataset_labels(n_per_class, seed):
    """``make_dataset``'s labels without its images: the same draws, in
    the same order, from the same generator, then its permutation."""
    rng = np.random.default_rng(seed + 1)
    for _ in range(10 * n_per_class):
        rng.integers(-2, 3, size=2)
        rng.uniform(0.7, 1.3)
        rng.normal(size=(28, 28))
    labels = np.repeat(np.arange(10, dtype=np.int32), n_per_class)
    return labels[rng.permutation(len(labels))]


def test_dataset_labels_are_make_datasets():
    for seed in (0, 1):
        want = _dataset_labels(7, seed)
        assert np.array_equal(ref_synthetic.make_dataset(7, seed=seed)[1],
                              want)
        assert np.array_equal(port_synthetic.make_dataset(7, seed=seed)[1],
                              want)


def _paper_partition(mod, part_fn, cfg):
    """The Table 3 cell's partition as ``FLSimulation`` builds it, with
    row indices for images (the partition only indexes them)."""
    labels = _dataset_labels(cfg.samples_per_class, cfg.seed)
    (tr_i, tr_l), _ = mod.train_test_split(np.arange(len(labels)), labels,
                                           seed=cfg.seed)
    return part_fn(tr_i, tr_l, cfg.partition)


@pytest.mark.parametrize("classes,seed,error", [
    (9, 0, None),
    (9, 1, "class 7 exhausted for client 26: need 5, have 1"),
    (6, 0, "class 1 exhausted for client 11: need 750, have 333"),
    (6, 1, "class 1 exhausted for client 11: need 750, have 355"),
    (2, 0, "class 0 exhausted for client 10: need 2250, have 1086"),
    (2, 1, "class 0 exhausted for client 10: need 2250, have 1045")])
def test_paper_cell_partition_is_the_references(classes, seed, error):
    """ROADMAP C10: Table 3's sweep cells partition at 9 classes a
    client for seed 0 only, and at 6 and 2 for no seed; both packages
    raise the same ``ValueError`` where one does, and split alike where
    neither does."""
    ref_cfg = ref_sweep.paper_cell_config("dcs", classes, "uniform", seed)
    cfg = sweep.paper_cell_config("dcs", classes, "uniform", seed)
    runs = ((ref_synthetic, ref_partition, ref_cfg),
            (port_synthetic, port_partition, cfg))
    if error is None:
        theirs, mine = (_paper_partition(*run) for run in runs)
        assert len(mine) == len(theirs) == cfg.partition.n_clients
        for (mi, ml), (ti, tl) in zip(mine, theirs):
            assert np.array_equal(mi, ti) and np.array_equal(ml, tl)
        return
    for run in runs:
        with pytest.raises(ValueError) as err:
            _paper_partition(*run)
        assert str(err.value) == error


def test_csv_of_the_reference_round_trips(ref_run):
    """The reference's CSV parses with the port's ``parse_csv_rows`` and
    re-emits byte for byte; ``aggregate_rows`` and ``rows_to_csv`` equal
    the reference's on the same rows."""
    rows, text, _ = ref_run
    parsed = sweep.parse_csv_rows(text)
    assert parsed == ref_sweep.parse_csv_rows(text)
    assert sweep.rows_to_csv(parsed) == text
    plain = [{k: v for k, v in r.items() if not k.endswith(("_mean",
                                                              "_std"))}
             for r in rows]
    assert sweep.aggregate_rows(plain) == ref_sweep.aggregate_rows(plain)
    assert sweep.rows_to_csv(rows) == text
    assert sweep.parse_csv_rows("not,a,sweep\n1,2,3\n") is None


def test_resume_keys_and_scenarios_are_the_references(ref_run):
    """``completed_job_rows`` finds the reference CSV's complete jobs as
    the reference's does (a torn job is left to rerun), and the
    synchronous scenario axis resolves to the base run in both."""
    _, text, _ = ref_run
    parsed = sweep.parse_csv_rows(text)
    jobs = [((s, 9, "uniform"), RunConfig().resolved()) for s in SCHEMES]
    ref_jobs = [((s, 9, "uniform"), RefRunConfig().resolved())
                for s in SCHEMES]
    torn = [r for r in parsed
            if not (r["scheme"] == "dcs" and r["round"] == ROUNDS - 1)]
    for rows in (parsed, torn):
        mine = sweep.completed_job_rows(rows, jobs, SEEDS, ROUNDS)
        theirs = ref_sweep.completed_job_rows(rows, ref_jobs, SEEDS, ROUNDS)
        assert mine == theirs
    assert sorted(k[0] for k in mine) == ["random"]
    base = RunConfig().resolved()
    assert sweep.scenario_runs(base, (0.0,), (0.0,), (0.0,)) == [base]
    assert sweep._job_key("dcs", 9, "uniform", base) == \
        ref_sweep._job_key("dcs", 9, "uniform", RefRunConfig().resolved())


_GROUPS = {}


def _group(fused=True):
    """Two seeds' port simulations (``_tiny``, ``dcs``), built once per
    probe mode; a scheme is a change of the stage config alone."""
    if fused not in _GROUPS:
        _GROUPS[fused] = [
            FLSimulation(_tiny("dcs", 9, "uniform", s),
                         run=RunConfig(fused_probe=fused), device="cpu")
            for s in SEEDS]
    return _GROUPS[fused]


@pytest.mark.parametrize("scheme", ["dcs", "ccs-fuzzy", "random"])
@pytest.mark.parametrize("fused", [True, False])
def test_seed_batched_prefix_is_single_seed_prefixes_bit_for_bit(fused,
                                                                 scheme):
    sims = _group(fused)
    cfg = dataclasses.replace(sims[0].stage_cfg, scheme=scheme)
    st = pipeline.stack_statics([s.statics for s in sims])
    params = {k: torch.stack([s.params[k] for s in sims])
              for k in sims[0].params}
    for rnd in (0, 3):
        fields = [s.round_fields(rnd) for s in sims]
        outs = pipeline.selection_prefix_seeds(
            st, params, rnd, pipeline.stack_fields(fields), cfg=cfg)
        for i, (sim, f) in enumerate(zip(sims, fields)):
            want = pipeline.selection_prefix(sim.statics, sim.params, rnd,
                                             f, cfg=cfg)
            assert set(outs) == set(want)
            for key, value in want.items():
                got = outs[key][i]
                assert got.dtype == value.dtype and torch.equal(got, value), \
                    (rnd, i, key)


_REF_PAIR = []


def _ref_pair():
    """Two seeds in both packages, the port on the reference's weights."""
    if not _REF_PAIR:
        refs = [RefSimulation(_ref_tiny("dcs", 9, "uniform", s))
                for s in SEEDS]
        ports = [FLSimulation(_tiny("dcs", 9, "uniform", s), device="cpu")
                 for s in SEEDS]
        for r, p in zip(refs, ports):
            p.params = params_from_jax(jax.device_get(r.params))
        _REF_PAIR.extend([refs, ports])
    return _REF_PAIR


@pytest.mark.parametrize("scheme", ["dcs", "ccs-fuzzy", "random"])
def test_seed_batched_prefix_matches_references(scheme):
    """Both packages' seed-batched prefixes on the reference's weights
    and draws (``test_torch_round.py``'s tolerances)."""
    refs, ports = _ref_pair()
    rcfg = dataclasses.replace(refs[0].stage_cfg, scheme=scheme)
    cfg = dataclasses.replace(ports[0].stage_cfg, scheme=scheme)
    st = ref_pipeline.stack_statics([r.statics for r in refs])
    rparams = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[r.params for r in refs])
    params = {k: torch.stack([p.params[k] for p in ports])
              for k in ports[0].params}
    for rnd in (0, 3):
        want = jax.device_get(ref_pipeline.selection_prefix_seeds(
            st, rparams, jnp.int32(rnd), jnp.stack([r.key for r in refs]),
            jnp.stack([r.net_key for r in refs]), cfg=rcfg))
        fields = [reference_fields(r, rnd) for r in refs]
        got = pipeline.selection_prefix_seeds(
            pipeline.stack_statics([p.statics for p in ports]), params, rnd,
            pipeline.stack_fields(fields), cfg=cfg)
        np.testing.assert_allclose(got["feats"].numpy(), want["feats"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["evals"].numpy(), want["evals"],
                                   rtol=0, atol=1e-3)
        for i in range(len(SEEDS)):
            margin = _eval_margin(want["evals"][i], cfg.e_tau)
            print(f"[{scheme} round {rnd} seed {i}] smallest eval margin "
                  f"{margin:.3g}")
            np.testing.assert_array_equal(
                got["mask"][i].numpy(), want["mask"][i],
                err_msg=f"masks differ; smallest margin {margin}")
        np.testing.assert_array_equal(got["survivors"].numpy(),
                                      want["survivors"])
        np.testing.assert_array_equal(got["n_straggler"].numpy(),
                                      want["n_straggler"])


def test_sweep_matches_the_references(ref_run, monkeypatch):
    """2 seeds x (dcs, random) x 2 rounds from the reference's weights on
    its draws: integer and comm columns equal, accuracy within 0.01,
    mean evaluation within 1e-3."""
    rows, _, sims = ref_run
    _reference_weights(monkeypatch)
    key = lambda r: (r["scheme"], r["seed"], r["round"])
    mine = sorted(_port_sweep(sims), key=key)
    theirs = sorted(rows, key=key)
    assert len(mine) == len(theirs) == len(SCHEMES) * len(SEEDS) * ROUNDS
    for a, b in zip(mine, theirs):
        for col in INT_COLS + EXACT_COLS:
            assert a[col] == b[col], (key(a), col, a[col], b[col])
        assert abs(a["accuracy"] - b["accuracy"]) <= 0.01, key(a)
        assert abs(a["mean_eval_selected"]
                   - b["mean_eval_selected"]) <= 1e-3, key(a)
        for col in ("n_selected_mean", "n_selected_std", "n_straggler_mean",
                    "n_straggler_std"):
            assert a[col] == b[col], (key(a), col)


@pytest.fixture(scope="module")
def dcs_group():
    """The port's ``dcs`` group, 2 seeds, 1 round, seed-batched."""
    return sweep.run_seed_group("dcs", 9, "uniform", SEEDS, 1,
                                cfg_fn=_tiny, device="cpu")


def test_two_port_sweeps_write_the_same_bytes(dcs_group, tmp_path):
    """A second sweep, and one without the seed-batched prefix, write the
    first one's CSV; the partial CSV of the last group is the final
    one."""
    first = sweep.rows_to_csv(sweep.aggregate_rows(dcs_group))
    kw = dict(cfg_fn=_tiny, device="cpu")
    rows = sweep.sweep(("dcs",), (9,), ("uniform",), SEEDS, 1,
                       out_path=str(tmp_path / "a.csv"), **kw)
    assert sweep.rows_to_csv(rows) == first
    assert (tmp_path / "a.csv").read_text() == first
    rows = sweep.sweep(("dcs",), (9,), ("uniform",), SEEDS, 1,
                       vmap_prefix=False, **kw)
    assert sweep.rows_to_csv(rows) == first


def test_worker_processes_write_the_same_bytes(dcs_group):
    """``workers=2``: the group runs in a spawned process (which imports
    ``cfg_fn`` by reference) and its rows are the in-process ones."""
    rows = sweep.sweep(("dcs",), (9,), ("uniform",), SEEDS, 1, workers=2,
                       cfg_fn=_tiny, device="cpu")
    assert sweep.rows_to_csv(rows) == sweep.rows_to_csv(
        sweep.aggregate_rows(dcs_group))


def test_seeds_that_do_not_stack_run_one_by_one(dcs_group, monkeypatch):
    """Statics of other shapes raise in ``stack_statics``; the group then
    takes the per-seed path, with the seed-batched path's rows."""
    sims = _group()
    st = sims[1].statics
    odd = dataclasses.replace(st, probe_images=st.probe_images[:-1])
    with pytest.raises(ValueError, match="probe_images"):
        pipeline.stack_statics([sims[0].statics, odd])
    calls = []

    def refuse(statics):
        calls.append(len(statics))
        raise ValueError("seeds differ")
    monkeypatch.setattr(pipeline, "stack_statics", refuse)
    rows = sweep.run_seed_group("dcs", 9, "uniform", SEEDS, 1,
                                cfg_fn=_tiny, device="cpu")
    assert calls == [len(SEEDS)]
    assert rows == dcs_group


def _mamdani(st):
    table, levels = build_rule_table()
    return (st.means, st.sigmas, torch.as_tensor(table),
            torch.as_tensor(levels), st.level_centers)


def test_plain_seed_probe_keeps_eq8_per_seed():
    """One seed's aux scaled 1000x: the plain seed version gives every
    seed its single call's features and evaluations (a maximum over the
    union of seeds would move the other seed's evaluations)."""
    sims = _group()
    st = pipeline.stack_statics([s.statics for s in sims])
    fields = pipeline.stack_fields([s.round_fields(0) for s in sims])
    cfg = sims[0].stage_cfg
    pos = pipeline.positions(st, cfg, torch.zeros(()))
    aux = pipeline.aux_features(st, cfg, pos, fields)
    params = {k: torch.stack([s.params[k] for s in sims])
              for k in sims[0].params}
    probe = (st.probe_images, st.probe_labels, st.probe_seg,
             st.probe_counts)
    _, before = ref.probe_fuzzy_ref(
        params, *probe, aux, *_mamdani(st), n_clients=cfg.n_clients)
    aux[1] *= 1000.0
    feats, evals = ref.probe_fuzzy_ref(
        params, *probe, aux, *_mamdani(st), n_clients=cfg.n_clients)
    for i, sim in enumerate(sims):
        f, e = ref.probe_fuzzy_ref(sim.params, *(t[i] for t in probe),
                                   aux[i], *_mamdani(st),
                                   n_clients=cfg.n_clients)
        assert torch.equal(feats[i], f) and torch.equal(evals[i], e), i
    assert torch.equal(evals[0], before[0])
    # the union's maxima would have flattened seed 0's SQ, TA and CC
    pooled = ref.fuzzy_eval_ref(feats.reshape(-1, 4), *_mamdani(st),
                                normalize=True).reshape(evals.shape)
    assert not torch.allclose(pooled[0], evals[0], atol=1e-3)


def test_plain_seed_election_is_each_fleets():
    rng = np.random.default_rng(3)
    pos = torch.tensor(rng.uniform(0, 1000, (3, 30)).astype(np.float32))
    ev = torch.tensor(rng.uniform(0, 100, (3, 30)).astype(np.float32))
    ev[2] *= 1000.0
    kw = dict(comm_range=200.0, top_m=2, e_tau=30.0)
    got = ref.neighbor_elect_ref(pos, ev, **kw)
    for i in range(3):
        assert torch.equal(got[i], ref.neighbor_elect_ref(pos[i], ev[i],
                                                          **kw))


def test_central_schemes_take_a_seed_axis_with_ties():
    """Tied evaluations keep the lower index in each seed, as a single
    call does (a stable sort, not ``torch.topk``); each seed's random
    pick is its own."""
    ev = torch.tensor([[5.0, 9.0, 9.0, 9.0, 1.0, 9.0],
                       [9.0, 9.0, 9.0, 9.0, 9.0, 9.0],
                       [0.0, 3.0, 2.0, 3.0, 3.0, 1.0]])
    got = ccs_fuzzy_select(ev, 3)
    for i in range(3):
        assert torch.equal(got[i], ccs_fuzzy_select(ev[i], 3))
    assert got.tolist()[1] == [1, 1, 1, 0, 0, 0]
    idx = torch.tensor([[0, 5], [3, 1], [2, 2]])
    picks = ccs_random_select(idx, 6)
    for i in range(3):
        assert torch.equal(picks[i], ccs_random_select(idx[i], 6))


@pytest.mark.parametrize("flags,item", [
    (["--multihost", "2"], "A11b"),
    (["--jit-cache-dir", "none"], "A14")])
def test_unported_flags_raise_naming_their_item(flags, item, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(sweep, "sweep", lambda *a, **k: pytest.fail(
        "the sweep ran"))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        sweep.main(["--seeds", "1", "--rounds", "1", "--device", "cpu",
                    "--out", str(tmp_path / "x.csv"), *flags])


@pytest.mark.parametrize("flags", [
    ["--resume"], ["--checkpoint-dir", "ckpt", "--checkpoint-every", "3"]],
    ids=" ".join)
def test_checkpoint_flags_reach_the_sweep(flags, tmp_path, monkeypatch):
    """The checkpoint flags reach ``sweep()`` as the reference's ``main``
    passes them: the snapshot directory defaults to ``OUT.ckpt``, and
    the grid's runs carry no checkpoints of their own."""
    from test_torch_cli import _parsed
    out = str(tmp_path / "x.csv")
    argv = ["--seeds", "1", "--rounds", "1", "--out", out, *flags]
    got = []
    monkeypatch.setattr(sweep, "sweep", lambda *a, **k: got.append(k) or [])
    assert sweep.main(argv + ["--device", "cpu"]) == 0
    ns = _parsed(ref_sweep.main, argv)
    ns["checkpoint_dir"] = ns["checkpoint_dir"] or out + ".ckpt"
    full = RefRunConfig.from_args(argparse.Namespace(**ns))
    (k,) = got
    assert (k["checkpoint_dir"], k["checkpoint_every"], k["resume"]) == (
        full.checkpoint_dir, full.checkpoint_every, full.resume)
    assert k["checkpoint_dir"] == (out + ".ckpt" if "--resume" in flags
                                   else "ckpt")
    assert all((r.checkpoint_dir, r.checkpoint_every, r.resume)
               == (None, 1, False) for r in k["runs"])


@pytest.mark.parametrize("flags", [
    ["--churn-rates", "0,0.3"], ["--staleness-lambdas", "1"],
    ["--agg-cadences", "30"], ["--server", "event"], ["--overlap-rounds"]],
    ids=" ".join)
def test_async_and_overlap_flags_reach_the_sweep(flags, tmp_path,
                                                 monkeypatch):
    """The scenario axis and the schedule flags give the sweep the
    ``RunConfig``s the reference's ``main`` builds from the same command
    line (its ``scenario_runs`` over its ``RunConfig.from_args``; the
    reference's default checkpoint directory left out)."""
    from test_torch_cli import _parsed, shared_fields
    argv = ["--seeds", "1", "--rounds", "1", "--out",
            str(tmp_path / "x.csv"), *flags]
    got = []
    monkeypatch.setattr(sweep, "sweep", lambda *a, **k: got.append(
        k["runs"]) or [])
    assert sweep.main(argv + ["--device", "cpu"]) == 0
    ns = _parsed(ref_sweep.main, argv)
    base = dataclasses.replace(
        RefRunConfig.from_args(argparse.Namespace(**ns)),
        checkpoint_dir=None)
    axes = ("churn_rates", "staleness_lambdas", "agg_cadences")
    if any(ns[k] is not None for k in axes):
        want = ref_sweep.scenario_runs(
            base, ns["churn_rates"] or (base.churn_rate,),
            ns["staleness_lambdas"] or (base.staleness_lambda,),
            ns["agg_cadences"] or (base.agg_cadence_s or 0.0,))
    else:
        want = [base]
    (runs,) = got
    assert len(runs) == len(want)
    for mine, theirs in zip(runs, want):
        a, b = shared_fields(mine, theirs)
        assert a == b


@pytest.mark.parametrize("workers", [1, 2])
def test_cli_runs_the_grid_on_the_client_mesh(workers, tmp_path,
                                              monkeypatch, capsys):
    """``--mesh clients=2`` (the ranks stubbed): the reference's banner
    line, then with one worker one spawn of 2 ranks running the whole
    grid (``_sweep_rank``, rank 0 writing the CSV) and each rank's
    launches; with ``--workers 2`` the grid runs here and each worker
    spawns 2 ranks of its own for its group (``_run_group_worker``)."""
    calls = []

    def spawn(fn, k, device, *, args=(), kwargs=None, **kw):
        calls.append((fn, k, args, kwargs))
        return [{"n_rows": 0, "device": "cpu", "launches": {},
                 "staged": {}, "rows": [], "prefix_s": []}] * k

    def grid(*a, **kw):
        for i, (s, c, d) in enumerate((s, c, d) for s in a[0]
                                      for c in a[1] for d in a[2]):
            sweep._run_group_worker((s, c, d, tuple(kw["seeds"]),
                                     kw["rounds"], kw["cfg_fn"], True,
                                     kw["runs"][0], "cpu", None, None, 1,
                                     False))
        return []
    monkeypatch.setattr(sweep, "spawn_ranks", spawn)
    monkeypatch.setattr(sweep, "sweep", grid)
    out = tmp_path / "x.csv"
    assert sweep.main(["--seeds", "2", "--rounds", "1", "--schemes",
                       "dcs,random", "--device", "cpu", "--mesh",
                       "clients=2", "--workers", str(workers), "--out",
                       str(out)]) == 0
    text = capsys.readouterr().out
    assert "[sweep] client mesh: {'clients': 2} over 2 ranks" in text
    if workers == 1:
        ((fn, k, args, kwargs),) = calls
        assert (fn, k) == (sweep._sweep_rank, 2)
        assert args == (("dcs", "random"), (9,), ("uniform",))
        assert kwargs["runs"][0].mesh == "clients=2"
        assert text.count("[sweep] rank ") == 2
    else:
        assert [(fn, k) for fn, k, _, _ in calls] == \
            [(sweep._group_rank, 2)] * 2


def test_cli_writes_the_references_csv_and_needs_a_card(tmp_path,
                                                       monkeypatch):
    """``--device cpu`` runs the sweep (here at the tiny profile) and
    writes a CSV with the reference's header; without it and without
    CUDA the CLI raises before any work."""
    monkeypatch.setattr(sweep, "fast_cell_config", _tiny)
    out = tmp_path / "s.csv"
    assert sweep.main(["--seeds", "2", "--rounds", "1", "--schemes",
                       "random", "--device", "cpu", "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == ",".join(ref_sweep.CSV_COLUMNS) and len(lines) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep.main(["--seeds", "1", "--rounds", "1", "--out", str(out)])
