"""Host-side inputs of the PyTorch port against the JAX reference.

Pure-numpy modules are held bit-equal (synthetic data, partition and
capacity groups, the 81-rule table, freeway mobility, Eq. 6 timing);
the tensor twins of mobility and the Reno predictor are held to fp32
rounding on the same inputs.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fuzzy import FuzzyEvaluatorConfig as RefFuzzyCfg
from repro.core.fuzzy import default_level_centers as ref_centers
from repro.core.rules import build_rule_table as ref_rules
from repro.data.synthetic import make_dataset as ref_make_dataset
from repro.data.synthetic import train_test_split as ref_split
from repro.fl import mobility as ref_mob
from repro.fl import network as ref_net
from repro.fl import timing as ref_timing
from repro.launch.fl_sim import fast_config as ref_fast_config
from repro_torch.core.fuzzy import FuzzyEvaluatorConfig, default_level_centers
from repro_torch.core.rules import build_rule_table, verify_anchors
from repro_torch.data.synthetic import make_dataset, train_test_split
from repro_torch.fl import mobility, network, partition, timing
from repro_torch.launch.fl_sim import fast_config

# ``repro.fl`` re-exports a ``partition`` function under the module's name
ref_part = importlib.import_module("repro.fl.partition")


def test_synthetic_data_bit_equal():
    for seed in (0, 3):
        a_im, a_lb = make_dataset(12, seed=seed)
        b_im, b_lb = ref_make_dataset(12, seed=seed)
        np.testing.assert_array_equal(a_im, b_im)
        np.testing.assert_array_equal(a_lb, b_lb)
        for x, y in zip(train_test_split(a_im, a_lb, seed=seed),
                        ref_split(b_im, b_lb, seed=seed)):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])


def test_partition_and_capacity_groups_bit_equal():
    im, lb = make_dataset(60, seed=1)
    cfg = partition.PartitionConfig(n_clients=8, big_clients=3,
                                    big_quantity=90, small_quantity=18,
                                    classes_per_client=6, seed=1)
    rcfg = ref_part.PartitionConfig(n_clients=8, big_clients=3,
                                    big_quantity=90, small_quantity=18,
                                    classes_per_client=6, seed=1)
    parts, rparts = partition.partition(im, lb, cfg), \
        ref_part.partition(im, lb, rcfg)
    for (a, b), (c, d) in zip(parts, rparts):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for uniform in (False, True):
        groups = partition.stack_clients(parts, batch_size=20,
                                         uniform=uniform)
        rgroups = ref_part.stack_clients(rparts, batch_size=20,
                                         uniform=uniform)
        assert len(groups) == len(rgroups)
        for g, r in zip(groups, rgroups):
            assert g.cap == r.cap
            for f in ("client_ids", "images", "labels", "n_valid"):
                np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
    for cap in (1, 20, 45, 4500):
        assert partition.steps_per_epoch(cap, 20) == \
            ref_part.steps_per_epoch(cap, 20)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fast_config_partition_and_mobility_match_reference(seed):
    """The fast profile's partition and mobility settings are the
    reference's for every run seed (its partition always uses seed 0),
    and so are the partitions they produce, sample for sample."""
    cfg, rcfg = fast_config("dcs", seed=seed), ref_fast_config("dcs",
                                                               seed=seed)
    assert cfg.seed == rcfg.seed == seed
    for f in ("partition", "mobility"):
        assert dataclasses.asdict(getattr(cfg, f)) == \
            dataclasses.asdict(getattr(rcfg, f)), f
    (im, lb), _ = train_test_split(*make_dataset(cfg.samples_per_class,
                                                 seed=seed), seed=seed)
    parts = partition.partition(im, lb, cfg.partition)
    rparts = ref_part.partition(im, lb, rcfg.partition)
    assert len(parts) == len(rparts) == cfg.partition.n_clients
    for (a, b), (c, d) in zip(parts, rparts):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_rule_table_and_fuzzy_parameters_bit_equal():
    table, levels = build_rule_table()
    rtable, rlevels = ref_rules()
    assert table.shape == (81, 4) and levels.shape == (81,)
    np.testing.assert_array_equal(table, rtable)
    np.testing.assert_array_equal(levels, rlevels)
    assert verify_anchors()
    cfg, rcfg = FuzzyEvaluatorConfig(), RefFuzzyCfg()
    np.testing.assert_array_equal(cfg.means, rcfg.means)
    np.testing.assert_array_equal(cfg.sigmas, rcfg.sigmas)
    assert cfg.e_tau == rcfg.e_tau
    np.testing.assert_array_equal(default_level_centers().numpy(),
                                  np.asarray(ref_centers(), np.float32))


def test_mobility_bit_equal_and_tensor_positions():
    for dist in ("uniform", "extreme"):
        cfg = mobility.MobilityConfig(n_vehicles=17, distribution=dist,
                                      seed=5)
        rcfg = ref_mob.MobilityConfig(n_vehicles=17, distribution=dist,
                                      seed=5)
        rank = np.random.default_rng(0).permutation(17)
        m, r = mobility.FreewayMobility(cfg, rank), \
            ref_mob.FreewayMobility(rcfg, rank)
        np.testing.assert_array_equal(m.x0, r.x0)
        np.testing.assert_array_equal(m.speeds, r.speeds)
        np.testing.assert_array_equal(m._jitter_phase, r._jitter_phase)
        for t in (0.0, 60.0, 1234.5):
            np.testing.assert_array_equal(m.positions(t), r.positions(t))
        f32 = np.float32
        for t in (0.0, 60.0, 540.0):
            got = mobility.positions(
                torch.tensor(m.x0, dtype=torch.float32),
                torch.tensor(m.speeds, dtype=torch.float32),
                torch.tensor(m._jitter_phase, dtype=torch.float32),
                torch.tensor(t, dtype=torch.float32),
                road_length_m=1000.0, speed_jitter=1.0)
            want = ref_mob.positions_jax(
                jnp.asarray(m.x0, f32), jnp.asarray(m.speeds, f32),
                jnp.asarray(m._jitter_phase, f32), jnp.float32(t),
                road_length_m=1000.0, speed_jitter=1.0)
            # fp32 cos of two libraries: a few ulps of a ~1e3 position
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-3)


def test_floor_mod_matches_jnp_mod():
    x = np.array([-2500.5, -1000.0, -0.0, 0.0, 3.25, 999.999, 1000.0,
                  2999.5], np.float32)
    got = mobility.floor_mod(torch.tensor(x), 1000.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.mod(x, 1000.0)))


def test_timing_bit_equal():
    rng = np.random.default_rng(2)
    slow, n = rng.uniform(1, 4, 9), rng.integers(10, 5000, 9)
    up = rng.uniform(0, 30, 9)
    cfg, rcfg = timing.TimingConfig(2, 20, deadline_s=60.0), \
        ref_timing.TimingConfig(2, 20, deadline_s=60.0)
    tr = timing.training_time_s(cfg, slow, n)
    np.testing.assert_array_equal(tr, ref_timing.training_time_s(rcfg, slow,
                                                                 n))
    np.testing.assert_array_equal(
        timing.completes_before_deadline(cfg, tr, up),
        ref_timing.completes_before_deadline(rcfg, tr, up))


def test_reno_predictor_and_upload_from_fields():
    n = 23
    cfg = network.NetworkConfig()
    rcfg = ref_net.NetworkConfig()
    pos = np.random.default_rng(4).uniform(0, 1000, n).astype(np.float32)
    shadow = np.asarray(ref_net.pinned_channel_shadow(n))
    loss_u = np.asarray(ref_net.cwnd_loss_fields(jax.random.PRNGKey(7), n))
    up = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (n,)))
    got = network.predicted_throughput_from_fields(
        cfg, torch.tensor(pos), torch.tensor(shadow), torch.tensor(loss_u))
    want = ref_net.predicted_throughput_from_fields(
        rcfg, jnp.asarray(pos), jnp.asarray(shadow), jnp.asarray(loss_u))
    # fp32 pow/log10 of two libraries; the AIMD steps are exact halvings
    # and increments, so only the rate cap carries the rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    got = network.upload_time_s_from_shadow(cfg, torch.tensor(pos), 5.2e6,
                                            torch.tensor(up))
    want = ref_net.upload_time_s_from_shadow(rcfg, jnp.asarray(pos), 5.2e6,
                                             jnp.asarray(up))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
