#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build all four CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print ptxas' register
   / shared-memory report; build the two simulations of the paths (the
   fast profile, 30 vehicles; the large fleet, 4096 vehicles at 1 per
   metre, whose uniform and extreme placements share one dataset);
3. hold each kernel against its plain PyTorch version on the card, TF32
   off, at the paths' shapes and at larger ones: ``windowed_counts``
   bit-equal at the large fleet's sorted round-0 arrays, at 65,536
   vehicles and on a clustered fleet; the windowed election's mask equal
   to ``neighbor_elect``'s wherever its flag is 0, and flagged wherever
   the rank-distance oracle flags;
4. time each kernel and its plain version with CUDA events and print its
   bound (the larger of bytes over 3.35 TB/s and operations over the
   fp32 peak of 67 TFLOP/s); time the whole windowed election against
   the dense kernel at 4096, 16,384 and 65,536 vehicles;
5. the paths, each with the launch counters reset just before and read
   just after: the round-0 selection prefix on the card against the
   port's CPU plain path, then ``FLSimulation`` (fast profile, ``dcs``)
   for 3 rounds on ``cuda``; the same 3 rounds again (default cuDNN
   algorithms); round 0's training and FedAvg held against the CPU's
   (fp64: to 1e-6; fp32: a reading); the 3 rounds twice under
   deterministic algorithms, which must repeat bit for bit; 1 unfused
   round; the large fleet for 2 rounds through ``elect="auto"`` (the
   windowed election, no dense launch unless a round overflows), then
   1 round of its extreme placement, which overflows and falls back to
   the dense kernel with the masks of ``elect="gather"``;
6. ``{"kernels": [...]}`` on the line before the last;
7. ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS needs a fixed workspace before its first call for phase 5's
# deterministic replay (torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # non-tensor-core fp32 peak

# CNN work per probe sample (conv1, conv2, fc1, fc2 multiply-adds x 2)
PROBE_FLOP_PER_SAMPLE = 2 * (28 * 28 * 32 * 25 + 14 * 14 * 64 * 32 * 25
                             + 3136 * 512 + 512 * 10)
# Mamdani per participant: 12 memberships x 5 ops, 81 rules x (3 min +
# 1 max), the COG's 9 x 3 ops + 1 division; Eq. 8 adds 4 maxima, 4
# multiplies and 8 clip ops
MAMDANI_OPS = 12 * 5 + 81 * 4 + 9 * 3 + 1
EQ8_OPS = 16
ELECT_OPS_PER_PAIR = 8             # sub, abs, 4 compares, and/or, add
LARGE_FLEET = 4096                 # vehicles of the large-fleet path


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for the work of one call."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def visited_pairs(m: int, block: int, window: int) -> int:
    """Row-candidate pairs that ``windowed_counts`` compares on (M,)
    arrays: row block ib sweeps blocks [ib - hops, ib + hops] clipped
    to the array, hops = ceil(window / block)."""
    nb, hops = m // block, -(-window // block)
    return sum(min(ib + hops, nb - 1) - max(ib - hops, 0) + 1
               for ib in range(nb)) * block * block


def large_fleet_config(distribution: str):
    """The large-fleet path: the fast profile's client shapes (12 big
    clients of 300 samples, the rest of 45) for 4096 vehicles on a
    4096 m road, the density of the reference's ``windowed_scaling``
    bench; 23000 samples per class is the smallest round figure that
    partitions 4096 clients without exhausting a class."""
    from repro_torch.fl.mobility import MobilityConfig
    from repro_torch.launch.fl_sim import fast_config
    cfg = fast_config("dcs", n_rounds=2, samples_per_class=23000)
    cfg.partition = dataclasses.replace(cfg.partition,
                                        n_clients=LARGE_FLEET)
    cfg.mobility = MobilityConfig(n_vehicles=LARGE_FLEET,
                                  road_length_m=float(LARGE_FLEET),
                                  distribution=distribution, seed=0)
    return cfg


@contextlib.contextmanager
def one_dataset():
    """While inside, ``FLSimulation`` builds each synthetic dataset once:
    simulations of one data configuration share it."""
    from repro_torch.fl import rounds
    make = rounds.make_dataset
    rounds.make_dataset = functools.lru_cache(maxsize=1)(make)
    try:
        yield
    finally:
        rounds.make_dataset = make


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    from repro_torch.core.elect import auto_window
    from repro_torch.core.rules import build_rule_table
    from repro_torch.device import fp32_strict
    from repro_torch.fl import pipeline
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.fl.schemes import elect_window
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.fl_sim import fast_config

    # -- 1. the card -------------------------------------------------------
    fp32_strict()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {kind}; {count} device(s); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)                          # name, power limit (nvidia-smi)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f}s")
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    table, levels = build_rule_table()

    # the main path's tensors: the fast-profile dcs simulation's round 0
    sim = FLSimulation(fast_config("dcs", n_rounds=3), run=RunConfig(),
                       device=dev)
    st, fields0 = sim.statics, sim.round_fields(0)
    pos0 = pipeline.positions(st, sim.stage_cfg,
                              torch.zeros((), device=dev))
    aux0 = pipeline.aux_features(st, sim.stage_cfg, pos0, fields0)
    s_main, n_main = st.probe_images.shape[0], sim.n
    log(f"[main path] probe S={s_main} N={n_main}")

    # the large-fleet path: its uniform and extreme placements share one
    # dataset; the uniform one's round 0 gives the path's shapes
    t0 = time.perf_counter()
    with one_dataset():
        big = FLSimulation(large_fleet_config("uniform"), run=RunConfig(),
                           device=dev)
        big_x = FLSimulation(large_fleet_config("extreme"),
                             run=RunConfig(), device=dev)
    big_cfg = big.stage_cfg
    window_big = elect_window(big_cfg)
    bst, bfields0 = big.statics, big.round_fields(0)
    bpos0 = pipeline.positions(bst, big_cfg, torch.zeros((), device=dev))
    big_probe = (big.params, bst.probe_images, bst.probe_labels,
                 bst.probe_seg, bst.probe_counts,
                 pipeline.aux_features(bst, big_cfg, bpos0, bfields0))
    s_big4k = bst.probe_images.shape[0]
    log(f"[large fleet] built both placements in "
        f"{time.perf_counter() - t0:.1f}s: probe S={s_big4k} N={big.n}, "
        f"elect={big_cfg.elect!r}, window {window_big} per side")
    if big_cfg.elect != "windowed":
        raise AssertionError("elect='auto' did not resolve to windowed")

    # the Mamdani operands as the kernel wrappers and as the plain
    # versions take them (the plain ones want the rule table as tensors)
    mam = (st.means, st.sigmas, table, levels, st.level_centers)
    mam_ref = (st.means, st.sigmas, torch.as_tensor(table, device=dev),
               torch.as_tensor(levels, device=dev), st.level_centers)
    main_probe = (sim.params, st.probe_images, st.probe_labels,
                  st.probe_seg, st.probe_counts, aux0)

    # -- 3. kernels against their plain versions -----------------------------
    def check_probe(label, inputs, n, col_maxima=None):
        f, e = ops.probe_fuzzy(*inputs, *mam, n_clients=n,
                               col_maxima=col_maxima)
        f0, e0 = ref.probe_fuzzy_ref(*inputs, *mam_ref, n_clients=n,
                                     col_maxima=col_maxima)
        torch.cuda.synchronize()
        # fp32 sums in another order (conv/GEMM tiling, client sums):
        # per-client losses to 1e-4 relative, evals 1e-3 on [0, 100]
        lf_rel = float(((f[:, 3] - f0[:, 3]).abs()
                        / f0[:, 3].abs().clamp(min=1e-12)).max())
        ev_abs = float((e - e0).abs().max())
        ok = (lf_rel <= 1e-4 and ev_abs <= 1e-3
              and bool(torch.isfinite(e).all())
              and torch.equal(f[:, :3], f0[:, :3]))
        log(f"[check] probe_fuzzy {label}: loss max rel err {lf_rel:.3g} "
            f"(tol 1e-4), eval max abs err {ev_abs:.3g} (tol 1e-3) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"probe_fuzzy {label} disagrees")
        return f, e, ev_abs

    feats_main, evals0, err_probe = check_probe(
        f"S={s_main} N={n_main}", main_probe, n_main)
    _, bevals0, err_probe_big = check_probe(
        f"S={s_big4k} N={big.n} (large fleet)", big_probe, big.n)
    err_probe = max(err_probe, err_probe_big)
    # the Eq. 8 seam with external column maxima
    check_probe(f"S={s_main} N={n_main} col_maxima", main_probe, n_main,
                col_maxima=feats_main.max(dim=0).values * 1.25)

    g = torch.Generator(device=dev).manual_seed(11)
    n_big, per = 1024, 256
    s_big = n_big * per
    big_seg = torch.arange(n_big, device=dev,
                           dtype=torch.int32).repeat_interleave(per)
    big_seg[::97] = n_big                      # overflow-lane padding rows
    check_probe(f"S={s_big} N={n_big}", (
        sim.params,
        torch.randn(s_big, 28, 28, 1, device=dev, generator=g),
        torch.randint(0, 10, (s_big,), device=dev, generator=g,
                      dtype=torch.int32),
        big_seg, torch.bincount(big_seg, minlength=n_big + 1)[:n_big].int(),
        torch.rand(n_big, 3, device=dev, generator=g)
        * torch.tensor([4500.0, 3e6, 1.0], device=dev)), n_big)

    x_big = torch.rand(1 << 20, 4, device=dev, generator=g) * torch.tensor(
        [4500.0, 3e6, 1.0, 3.0], device=dev)
    err_fuzzy = 0.0
    for label, x in ((f"P={n_main}", feats_main),
                     (f"P={x_big.shape[0]}", x_big)):
        for normalize in (False, True):
            xin = x if normalize else (x / x.max(dim=0).values)
            got = ops.fuzzy_eval(xin, *mam, normalize=normalize)
            want = ref.fuzzy_eval_ref(xin, *mam_ref, normalize=normalize)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if x is feats_main:
                err_fuzzy = max(err_fuzzy, err)
            log(f"[check] fuzzy_eval {label} normalize={normalize}: max abs "
                f"err {err:.3g} (tol 1e-4) {'OK' if err <= 1e-4 else 'FAIL'}")
            if err > 1e-4:
                raise AssertionError(f"fuzzy_eval {label} disagrees")

    cfg = sim.stage_cfg
    elect_kw = dict(comm_range=cfg.comm_range_m, top_m=cfg.top_m,
                    e_tau=cfg.e_tau)
    rng = np.random.default_rng(5)
    elect_cases = [("N=30", pos0.contiguous(), evals0.contiguous())]
    for n in (4096, 16384):
        pos = rng.uniform(0, 1000 * n / 30, n).astype(np.float32)
        ev = rng.uniform(0, 100, n).astype(np.float32)
        pos[:6] = [100, 300, 300, 500, 700, 900]       # d == comm_range
        ev[:6] = [50, 50, 50, 30, 30, 29.999]           # ties, E_tau
        ev[6:40] = 50.0
        elect_cases.append((f"N={n}", torch.tensor(pos, device=dev),
                            torch.tensor(ev, device=dev)))
    for label, pos, ev in elect_cases:
        got = ops.neighbor_elect(pos, ev, **elect_kw)
        want = ref.neighbor_elect_ref(pos, ev, **elect_kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        log(f"[check] neighbor_elect {label}: bit-equal {same}, "
            f"{int(want.sum())} selected {'OK' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"neighbor_elect {label} not bit-equal")

    # windowed counts: bit-equal, on sorted arrays the election builds
    # (M a multiple of the block, so no padding): the large fleet's
    # round 0, a 65,536-vehicle fleet at 1 per metre, a clustered fleet
    def sorted_fleet(pos, ev):
        order = torch.argsort(pos, stable=True)
        return pos[order], ev[order], order.to(torch.int32)

    def uniform_fleet(n, seed):
        r = np.random.default_rng(seed)
        pos = r.uniform(0, n, n).astype(np.float32)
        ev = r.uniform(0, 100, n).astype(np.float32)
        pos[:6] = [100, 300, 300, 500, 700, 900]       # d == comm_range
        ev[:6] = [50, 50, 50, 30, 30, 29.999]           # ties, E_tau
        ev[6:40] = 50.0
        return (torch.tensor(pos, device=dev), torch.tensor(ev, device=dev))

    clustered = uniform_fleet(LARGE_FLEET, 7)
    clustered[0][: LARGE_FLEET // 2] = torch.rand(
        LARGE_FLEET // 2, device=dev, generator=g) * 150.0
    fleets = {"large fleet round 0": (bpos0.contiguous(),
                                      bevals0.contiguous()),
              "N=65536 1/m": uniform_fleet(65536, 6),
              f"N={LARGE_FLEET} clustered": clustered}
    count_kw = dict(comm_range=big_cfg.comm_range_m, e_tau=big_cfg.e_tau)
    win_cases = {}
    for label, (pos, ev) in fleets.items():
        m = pos.shape[0]
        sp, se, sg = sorted_fleet(pos, ev)
        win_cases[label] = (sp, se, sg)
        for window in sorted({16, 300, auto_window(m, 200.0, float(m))}):
            kw = dict(count_kw, n_valid=m, window=window, block=128)
            got = ops.windowed_counts(sp, se, sg, **kw)
            want = ref.windowed_counts_ref(sp, se, sg, **kw)
            again = ops.windowed_counts(sp, se, sg, **kw)
            torch.cuda.synchronize()
            same = torch.equal(got, want) and torch.equal(got, again)
            log(f"[check] windowed_counts {label} M={m} window {window}: "
                f"bit-equal and repeatable {same}, counts sum "
                f"{int(want.sum())} {'OK' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"windowed_counts {label} differs")

    # the windowed election against the dense kernel and the oracle
    for label, (pos, ev) in fleets.items():
        m = pos.shape[0]
        if m != LARGE_FLEET:
            continue
        dense = ops.neighbor_elect(pos, ev, **elect_kw)
        for window in (16, 64, auto_window(m, 200.0, float(m))):
            mask, ovf = ops.neighbor_elect_windowed(pos, ev, window=window,
                                                    **elect_kw)
            _, oracle = ref.windowed_elect_ref(pos, ev, window=window,
                                               **elect_kw)
            ovf, oracle = int(ovf), int(oracle)
            ok = ovf >= oracle and (ovf == 1 or torch.equal(mask, dense))
            log(f"[check] windowed election {label} window {window}: "
                f"flag {ovf} (oracle {oracle}), mask equals dense "
                f"{torch.equal(mask, dense)} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"windowed election {label} wrong")

    # -- 4. timing -----------------------------------------------------------
    param_bytes = sum(t.numel() * 4 for t in sim.params.values())
    probe_bytes = (s_main * (28 * 28 * 4 + 8) + n_main * (4 + 12 + 16 + 4)
                   + param_bytes)
    pos_big, ev_big = elect_cases[-1][1:]
    n_eb, p_big = pos_big.shape[0], x_big.shape[0]
    sp_b, se_b, sg_b = win_cases["large fleet round 0"]
    sp_h, se_h, sg_h = win_cases["N=65536 1/m"]
    wkw_b = dict(count_kw, n_valid=big.n, window=window_big, block=128)
    window_h = auto_window(65536, 200.0, 65536.0)
    wkw_h = dict(count_kw, n_valid=65536, window=window_h, block=128)
    # name -> (shape, kernel call, plain call, iterations, (bound, by));
    # the first row of each kernel is its path's shape
    cases = [
        ("probe_fuzzy", f"S={s_main} N={n_main}",
         lambda: ops.probe_fuzzy(*main_probe, *mam, n_clients=n_main),
         lambda: ref.probe_fuzzy_ref(*main_probe, *mam_ref,
                                     n_clients=n_main), 20,
         bound(probe_bytes, s_main * PROBE_FLOP_PER_SAMPLE)),
        ("fuzzy_eval", f"P={n_main} normalize=True",
         lambda: ops.fuzzy_eval(feats_main, *mam, normalize=True),
         lambda: ref.fuzzy_eval_ref(feats_main, *mam_ref, normalize=True),
         200, bound(n_main * 20, n_main * (MAMDANI_OPS + EQ8_OPS))),
        ("neighbor_elect", f"N={n_main}",
         lambda: ops.neighbor_elect(pos0, evals0, **elect_kw),
         lambda: ref.neighbor_elect_ref(pos0, evals0, **elect_kw), 200,
         bound(n_main * 12, n_main * n_main * ELECT_OPS_PER_PAIR)),
        ("probe_fuzzy", f"S={s_big4k} N={big.n} (large fleet)",
         lambda: ops.probe_fuzzy(*big_probe, *mam, n_clients=big.n),
         lambda: ref.probe_fuzzy_ref(*big_probe, *mam_ref,
                                     n_clients=big.n), 3,
         bound(s_big4k * (28 * 28 * 4 + 8) + big.n * 36 + param_bytes,
               s_big4k * PROBE_FLOP_PER_SAMPLE)),
        ("windowed_counts", f"M={big.n} window {window_big}",
         lambda: ops.windowed_counts(sp_b, se_b, sg_b, **wkw_b),
         lambda: ref.windowed_counts_ref(sp_b, se_b, sg_b, **wkw_b), 200,
         bound(big.n * 16, visited_pairs(big.n, 128, window_big)
               * ELECT_OPS_PER_PAIR)),
        ("windowed_counts", f"M=65536 window {window_h}",
         lambda: ops.windowed_counts(sp_h, se_h, sg_h, **wkw_h),
         lambda: ref.windowed_counts_ref(sp_h, se_h, sg_h, **wkw_h), 50,
         bound(65536 * 16, visited_pairs(65536, 128, window_h)
               * ELECT_OPS_PER_PAIR)),
        ("fuzzy_eval", f"P={p_big} normalize=True",
         lambda: ops.fuzzy_eval(x_big, *mam, normalize=True),
         lambda: ref.fuzzy_eval_ref(x_big, *mam_ref, normalize=True), 20,
         bound(p_big * 20, p_big * (MAMDANI_OPS + EQ8_OPS))),
        ("neighbor_elect", f"N={n_eb}",
         lambda: ops.neighbor_elect(pos_big, ev_big, **elect_kw),
         lambda: ref.neighbor_elect_ref(pos_big, ev_big, **elect_kw), 20,
         bound(n_eb * 12, n_eb * n_eb * ELECT_OPS_PER_PAIR)),
    ]
    timings = {}
    for name, shape, fn, plain, iters, (b_ms, b_by) in cases:
        ms, plain_ms = time_ms(fn, iters), time_ms(plain, iters)
        timings.setdefault(name, (ms, plain_ms, b_ms, b_by))
        log(f"[time] {name} {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")

    # the whole windowed election (sort, counts, coverage, scatter)
    # against the dense kernel, at 1 vehicle per metre
    for n in (LARGE_FLEET, 16384, 65536):
        pos, ev = (fleets["large fleet round 0"] if n == LARGE_FLEET
                   else uniform_fleet(n, n))
        window = auto_window(n, 200.0, float(n))
        win_ms = time_ms(lambda: ops.neighbor_elect_windowed(
            pos, ev, window=window, **elect_kw), 50)
        dense_ms = time_ms(lambda: ops.neighbor_elect(pos, ev, **elect_kw),
                           50)
        log(f"[time] election N={n} window {window}: windowed "
            f"{win_ms:.4f} ms, dense kernel {dense_ms:.4f} ms, "
            f"windowed/dense {win_ms / dense_ms:.3f}")

    # -- 5. the main path ------------------------------------------------------
    # the round-0 prefix on the card against the port's CPU plain path
    cpu_sim = FLSimulation(fast_config("dcs", n_rounds=3), run=RunConfig(),
                           device="cpu")
    cpu_sim.params = {k: v.cpu() for k, v in sim.params.items()}
    got = sim.selection_state(0)
    want = cpu_sim.selection_state(0)
    ev_err = float((got["evals"].cpu() - want["evals"]).abs().max())
    same_mask = torch.equal(got["mask"].cpu(), want["mask"])
    log(f"[check] prefix round 0 cuda vs cpu: eval max abs err {ev_err:.3g} "
        f"(tol 1e-3), masks equal {same_mask}")
    if ev_err > 1e-3 or not same_mask:
        raise AssertionError("the card's prefix disagrees with the CPU's")
    del cpu_sim

    def drive(s, n_rounds, label):
        build.reset_launches()
        rows = []
        for r in range(n_rounds):
            # run_round's two halves, timed apart: the prefix on the card,
            # then the gather, local SGD, FedAvg and the accuracy
            fields = s.round_fields(r)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = s.selection_state(r, fields)
            torch.cuda.synchronize()
            t_prefix = time.perf_counter()
            row = s.finish_round(r, state, fields)
            torch.cuda.synchronize()
            row["prefix_s"] = t_prefix - t
            row["round_s"] = time.perf_counter() - t
            row["elect_overflow"] = int(state["elect_overflow"])
            rows.append(row)
            log(f"[main path] {label} {json.dumps(row)}")
        counts = dict(build.LAUNCHES)
        log(f"[main path] {label} launches {counts}")
        for row in rows:
            if not (0.0 <= row["accuracy"] <= 1.0
                    and math.isfinite(row["mean_eval_selected"])
                    and 0 <= row["n_aggregated"] <= row["n_selected"]
                    <= s.n):
                raise AssertionError(f"bad row {row}")
        for t in s.params.values():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("non-finite params after training")
        return counts, rows

    def max_gap(a, b):
        return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)

    def accuracies(rows):
        return [round(row["accuracy"], 4) for row in rows]

    params0 = {k: v.clone() for k, v in sim.params.items()}
    fused, rows_a = drive(sim, 3, "dcs fused")
    params_a = sim.params

    # the same 3 rounds again from the same params: cuDNN's default
    # algorithms may sum in another order from run to run
    sim.params = {k: v.clone() for k, v in params0.items()}
    _, rows_b = drive(sim, 3, "dcs fused repeat")
    log(f"[repeat] default algorithms: accuracy {accuracies(rows_a)} / "
        f"{accuracies(rows_b)}, params max abs gap after 3 rounds "
        f"{max_gap(params_a, sim.params):.3g}")

    # round 0's training half (cohort gather, grouped-conv local SGD,
    # FedAvg) on the card against the port's CPU path, fed the same
    # survivors, draws and params.  In fp32 the two sum in another order
    # and a ReLU or max-pool kink that flips on one side moves the params
    # by ~lr * grad, so the fp32 gap is a reading, beside the CPU's own
    # gap when its start is nudged by one ulp.  In fp64 no kink flips:
    # the params must agree to 1e-6 (FedAvg still sums in fp32).
    fields = sim.round_fields(0)
    survivors = sim.selection_state(0, fields)["survivors"].cpu().numpy()
    c = sim.cfg

    def train_half(params, groups):
        trained = pipeline.train_groups(
            params, groups, sim._group_steps, survivors,
            lambda i: fields.perms[i], epochs=c.local_epochs,
            batch_size=c.batch_size, lr=c.lr)
        return pipeline.aggregate(params, trained)

    def on(device, dtype):
        return {k: v.to(device, dtype) for k, v in params0.items()}

    groups64 = [dataclasses.replace(g, images=g.images.astype(np.float64))
                for g in sim.groups]
    gap64 = max_gap(train_half(on(dev, torch.float64), groups64),
                    train_half(on("cpu", torch.float64), groups64))
    cpu32 = train_half(on("cpu", torch.float32), sim.groups)
    gap32 = max_gap(train_half(on(dev, torch.float32), sim.groups), cpu32)
    nudged = {k: torch.nextafter(v, torch.full_like(v, math.inf))
              for k, v in on("cpu", torch.float32).items()}
    gap_ulp = max_gap(train_half(nudged, sim.groups), cpu32)
    log(f"[check] round 0 training+FedAvg cuda vs cpu: params max abs err "
        f"fp64 {gap64:.3g} (tol 1e-6) {'OK' if gap64 <= 1e-6 else 'FAIL'}; "
        f"fp32 {gap32:.3g} (the CPU against itself from a start one ulp "
        f"up: {gap_ulp:.3g})")
    if gap64 > 1e-6:
        raise AssertionError("the card's training disagrees with the CPU's")

    # deterministic algorithms: the 3 rounds replayed twice must repeat
    # bit for bit, rows and params
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    replays = []
    for _ in range(2):
        sim.params = {k: v.clone() for k, v in params0.items()}
        replays.append((sim.run(3), sim.params))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    (rows_c, params_c), (rows_d, params_d) = replays
    same = rows_c == rows_d and max_gap(params_c, params_d) == 0.0
    log(f"[check] deterministic replay: accuracy {accuracies(rows_c)} / "
        f"{accuracies(rows_d)}, rows and params bit-equal {same} "
        f"{'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("deterministic rounds on the card do not repeat")

    unfused_sim = FLSimulation(fast_config("dcs", n_rounds=1),
                               run=RunConfig(fused_probe=False), device=dev)
    unfused, _ = drive(unfused_sim, 1, "dcs unfused")
    # the large fleet through elect="auto": round 0's windowed mask is
    # the dense election's (flag 0), then 2 rounds launch windowed_counts
    # once each and neighbor_elect only for a round that overflowed
    state_w = big.selection_state(0, bfields0)
    state_g = big.selection_state(0, bfields0, elect="gather")
    flag0 = int(state_w["elect_overflow"])
    _, oracle0 = ref.windowed_elect_ref(state_w["pos"], state_w["evals"],
                                        window=window_big, **elect_kw)
    last_ev = float(state_w["evals"][torch.argmax(state_w["pos"])])
    same = torch.equal(state_w["mask"], state_g["mask"])
    log(f"[check] large fleet round 0: overflow {flag0} (oracle "
        f"{int(oracle0)}; last vehicle's eval {last_ev:.3f}), windowed "
        f"mask equals gather's {same}, {int(state_w['n_selected'])} "
        f"selected")
    if flag0 < int(oracle0) or (flag0 == 0 and not same):
        raise AssertionError("large fleet: windowed election is wrong")
    del state_w, state_g
    windowed, rows_w = drive(big, 2, "large fleet uniform")
    n_over = sum(row["elect_overflow"] for row in rows_w)
    if n_over:
        log(f"[main path] large fleet uniform: {n_over} round(s) "
            f"overflowed the window and ran the dense fallback")
    if (windowed["windowed_counts"] != 2
            or windowed["neighbor_elect"] != n_over
            or any(row["n_selected"] <= 0 for row in rows_w)):
        raise AssertionError(f"large fleet uniform: launches {windowed}, "
                             f"rows {rows_w}")

    # the extreme placement crowds half the fleet into 150 m: the window
    # overflows and the round runs on the dense kernel's masks, the same
    # as elect="gather" gives
    xfields = big_x.round_fields(0)
    flag_x = int(big_x.selection_state(0, xfields)["elect_overflow"])
    gather_x = big_x.selection_state(0, xfields,
                                     elect="gather")["mask"].cpu().numpy()
    fallback, rows_x = drive(big_x, 1, "large fleet extreme")
    same = bool(np.array_equal(big_x.last_mask, gather_x))
    log(f"[check] large fleet extreme: overflow {flag_x}, round mask "
        f"equals gather's {same}")
    if (flag_x != 1 or rows_x[0]["elect_overflow"] != 1 or not same
            or fallback["neighbor_elect"] != 1
            or fallback["windowed_counts"] != 1
            or rows_x[0]["n_selected"] <= 0):
        raise AssertionError(f"large fleet extreme: launches {fallback}, "
                             f"rows {rows_x}")

    launches = {"probe_fuzzy": fused["probe_fuzzy"],
                "neighbor_elect": fused["neighbor_elect"],
                "fuzzy_eval": unfused["fuzzy_eval"],
                "windowed_counts": windowed["windowed_counts"]}
    if (min(launches.values()) <= 0 or unfused["neighbor_elect"] <= 0
            or windowed["probe_fuzzy"] != 2 + n_over):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # -- 6. the kernels line ---------------------------------------------------
    meta = {
        "probe_fuzzy": ("src/repro_torch/csrc/probe_fuzzy.cu",
                        "src/repro/kernels/probe_fuzzy.py:230", err_probe),
        "fuzzy_eval": ("src/repro_torch/csrc/fuzzy_eval.cu",
                       "src/repro/kernels/fuzzy_eval.py:101", err_fuzzy),
        "neighbor_elect": ("src/repro_torch/csrc/neighbor_elect.cu",
                           "src/repro/kernels/neighbor_elect.py:66", 0.0),
        "windowed_counts": ("src/repro_torch/csrc/windowed_counts.cu",
                            "src/repro/kernels/neighbor_elect.py:141", 0.0),
    }
    kernels = []
    for name in build.KERNELS:
        src, replaces, err = meta[name]
        ms, plain_ms, b_ms, b_by = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
