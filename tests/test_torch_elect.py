"""The port's windowed DCS election against the JAX reference.

``windowed_counts_ref`` (the kernel's plain version) is held bit-equal
to ``windowed_counts_pallas`` in interpret mode: both visit the same
block-granular candidate set.  The port's ``windowed_elect`` (on the
CPU, through that plain version) gives the reference's overflow flag,
and wherever the flag is 0 the dense election's mask.  Inputs are made
from a seed with numpy and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import elect as ref_elect
from repro.kernels import ref as ref_kref
from repro.kernels.neighbor_elect import windowed_counts_pallas
from repro_torch.core import elect
from repro_torch.kernels import build, ops, ref
from torch_threads import torch_intra_op_threads  # noqa: F401

CR, E_TAU = 200.0, 30.0


def _fleet(n, seed, kind="random", road=None):
    """Positions and evaluations of ``n`` vehicles.  ``random`` forces
    pairs exactly ``comm_range`` apart, duplicate positions and tied
    evaluations (integers and halves are exact in fp32); ``below`` puts
    every vehicle under E_tau; ``tied`` gives every vehicle one
    evaluation; ``clustered`` packs the fleet into two 150 m crowds."""
    rng = np.random.default_rng(seed)
    road = float(road or max(n, 1000))
    pos = rng.uniform(0, road, n).astype(np.float32)
    ev = rng.uniform(0, 100, n).astype(np.float32)
    if kind == "random" and n >= 12:
        pos[:8] = [100, 300, 300, 500, 100.5, 300.5, 700, 900]
        ev[:8] = [50, 50, 50, 29.999, 30, 30, 80, 80]
        ev[8:12] = ev[0]
    elif kind == "below":
        ev = rng.uniform(0, E_TAU - 1, n).astype(np.float32)
    elif kind == "tied":
        ev[:] = 55.0
    elif kind == "clustered":
        half = n // 2
        pos[:half] = rng.uniform(0, 150, half)
        pos[half:] = rng.uniform(road - 150, road, n - half)
    return pos, ev


def _sorted_padded(m, seed):
    """A fleet sorted by position and padded as ``sorted_window_counts``
    pads it: ``(sp, se, sg, block)``."""
    pos, ev = _fleet(m, seed, road=m * 0.75)
    order = np.argsort(pos, kind="stable")
    block = min(128, max(32, m))
    pad = -(-m // block) * block - m
    sp = np.concatenate([pos[order], np.full(pad, elect.SENT_POS)])
    se = np.concatenate([ev[order], np.full(pad, elect.SENT_EV)])
    sg = np.concatenate([order, np.full(pad, m)])
    return (sp.astype(np.float32), se.astype(np.float32),
            sg.astype(np.int32), block)


@pytest.mark.parametrize("window", [1, 16, 127, 128, 300])
@pytest.mark.parametrize("m", [32, 100, 128, 129, 1000, 2048])
def test_windowed_counts_plain_bit_equal_to_pallas(m, window):
    sp, se, sg, block = _sorted_padded(m, seed=m + window)
    kw = dict(comm_range=CR, e_tau=E_TAU, n_valid=m, window=min(window, m),
              block=block)
    want = windowed_counts_pallas(jnp.asarray(sp), jnp.asarray(se),
                                  jnp.asarray(sg), interpret=True, **kw)
    launches = dict(build.LAUNCHES)
    got = ops.windowed_counts(torch.tensor(sp), torch.tensor(se),
                              torch.tensor(sg), **kw)
    assert build.LAUNCHES == launches        # CPU tensors: plain version
    assert got.dtype == torch.int32 and got.shape == (sp.shape[0],)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _windows(n, road):
    return sorted({elect.auto_window(n, CR, road), 2, 16, 64})


@pytest.mark.parametrize("kind", ["random", "below", "tied", "clustered"])
@pytest.mark.parametrize("n", [1, 30, 512, 2048])
def test_windowed_elect_matches_reference_or_flags(n, kind):
    """Overflow flags equal the reference's (``impl="jnp"``) and are
    raised wherever the rank-distance oracle raises one; where the flag
    is 0 the masks equal the reference's, the oracle's and the dense
    election's."""
    road = max(n, 1000)
    pos, ev = _fleet(n, seed=n, kind=kind, road=road)
    tp, te = torch.tensor(pos), torch.tensor(ev)
    kw = dict(comm_range=CR, top_m=2, e_tau=E_TAU)
    dense = ref.neighbor_elect_ref(tp, te, **kw).numpy()
    flags = []
    for window in _windows(n, road):
        mask, ovf = elect.windowed_elect(tp, te, window=window, **kw)
        assert mask.dtype == torch.int32 and ovf.dtype == torch.int32
        rmask, rovf = ref_elect.windowed_elect(
            jnp.asarray(pos), jnp.asarray(ev), window=window, impl="jnp",
            **kw)
        omask, oovf = ref_kref.windowed_elect_ref(
            jnp.asarray(pos), jnp.asarray(ev), window=window, **kw)
        pmask, povf = ref.windowed_elect_ref(tp, te, window=window, **kw)
        assert int(ovf) == int(rovf), window
        assert int(povf) == int(oovf), window
        assert int(ovf) >= int(oovf), window
        np.testing.assert_array_equal(pmask.numpy(), dense)
        np.testing.assert_array_equal(np.asarray(omask), dense)
        if int(ovf) == 0:
            np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
            np.testing.assert_array_equal(mask.numpy(), dense)
        flags.append(int(ovf))
    if kind == "below" or n == 1:
        assert flags == [0] * len(flags)     # no valid neighbour to miss
    if n == 2048 and kind == "random":
        assert flags[0] == 1 and flags[-1] == 0   # window 2 / auto window


def test_window_coverage_sees_a_neighbour_at_comm_range():
    """A neighbour just past ``window`` ranks but exactly ``comm_range``
    away is seen by the coverage check (flag 1); the same fleet at a
    window that holds it is covered."""
    pos = np.array([0.0, 50.0, 100.0, 200.0], np.float32)
    ev = np.full(4, 60.0, np.float32)
    tp, te = torch.tensor(pos), torch.tensor(ev)
    kw = dict(comm_range=CR, top_m=2, e_tau=E_TAU)
    for window, flag in ((1, 1), (2, 1), (3, 0)):
        _, ovf = elect.windowed_elect(tp, te, window=window, **kw)
        _, rovf = ref_elect.windowed_elect(jnp.asarray(pos), jnp.asarray(ev),
                                           window=window, impl="jnp", **kw)
        assert int(ovf) == int(rovf) == flag, window


@pytest.mark.parametrize("last_ev", [60.0, 10.0])
def test_window_coverage_flags_a_valid_last_vehicle_as_the_reference(
        last_ev):
    """The reference's coverage check over-flags whenever the last
    vehicle in road order clears E_tau and the window is shorter than
    the fleet (its right-hand ``count_in`` clips an empty interval onto
    the last slot; ROADMAP C5).  The port keeps its flags: here every
    in-range pair is 1 rank apart, so the oracle never flags, yet both
    packages flag when the last vehicle is valid.  The mask is the
    dense one either way."""
    pos = np.array([0.0, 150.0, 300.0, 450.0, 600.0], np.float32)
    ev = np.array([70.0, 50.0, 80.0, 40.0, last_ev], np.float32)
    tp, te = torch.tensor(pos), torch.tensor(ev)
    kw = dict(comm_range=CR, top_m=1, e_tau=E_TAU, window=1)
    mask, ovf = elect.windowed_elect(tp, te, **kw)
    _, rovf = ref_elect.windowed_elect(jnp.asarray(pos), jnp.asarray(ev),
                                       impl="jnp", **kw)
    dense, oracle = ref.windowed_elect_ref(tp, te, **kw)
    want = int(last_ev >= E_TAU)
    assert (int(ovf), int(rovf), int(oracle)) == (want, want, 0)
    if want == 0:
        assert torch.equal(mask, dense)


def test_auto_window_matches_reference():
    for n in (0, 1, 30, 511, 512, 4096, 65536, 10 ** 6):
        for cr in (0.0, 50.0, 200.0, 1000.0):
            for road in (0.0, 1.0, 1000.0, 4096.0, float(n), 1e6):
                assert elect.auto_window(n, cr, road) == \
                    ref_elect.auto_window(n, cr, road), (n, cr, road)
    assert elect.auto_window(4096, 200.0, 4096.0) == 616


def test_windowed_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.windowed_counts import windowed_counts_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        windowed_counts_cuda(torch.zeros(32), torch.zeros(32),
                             torch.zeros(32, dtype=torch.int32),
                             comm_range=1.0, e_tau=0.0, n_valid=32,
                             window=4, block=32)
