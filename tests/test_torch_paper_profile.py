"""A round of the paper's profile (``paper_config``, Table 3: 30 local
epochs, a 20 s deadline, 12 clients of 4500 samples and 18 of 45) in
the port against the JAX reference, the port fed the reference's
draws (``test_torch_round.py``'s harness).

At this profile Eq. 6 makes every 4500-sample client a straggler; on
the reference's draws for seed 0, round 4 is the first ``dcs`` round in
which any client (two of the 60-cap group) meets the deadline, so it
trains 90 local-SGD steps a client.  Both packages run it from the same
parameters.
"""
import jax

from repro.fl.rounds import FLSimulation as RefSimulation
from repro.fl.runconfig import RunConfig as RefRunConfig
from repro.launch import fl_sim as ref_fl_sim
from repro_torch.convert import params_from_jax
from repro_torch.fl.rounds import FLSimulation
from repro_torch.launch import fl_sim
from test_torch_paper import _check_row
from test_torch_round import _check_round, reference_fields
from torch_threads import torch_intra_op_threads  # noqa: F401

TRAINED_ROUND = 4


def test_paper_round_matches_reference():
    """Masks and integer columns equal, accuracy within 0.01
    (``_check_round``: 30 epochs of fp32 SGD amplify the ulps of the
    two libraries' convolutions), the async and comm columns ``==``."""
    ref = RefSimulation(ref_fl_sim.paper_config("dcs"),
                        run=RefRunConfig(overlap_rounds=False))
    port = FLSimulation(fl_sim.paper_config("dcs"), device="cpu",
                        fields=lambda r: reference_fields(ref, r))
    port.params = params_from_jax(jax.device_get(ref.params))
    want, got = _check_round(ref, port, TRAINED_ROUND)
    assert got["n_aggregated"] > 0
    _check_row(want, got)
