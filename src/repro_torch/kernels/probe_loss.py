"""The packed Eq. 7 probe alone on the card (replaces
``repro/kernels/probe_fuzzy.py::probe_loss_pallas``).

``probe_loss_cuda`` launches ``csrc/probe_loss.cu``: phases 0-4 of the
fused kernel (``csrc/probe_phases.cuh``), then the Eq. 7 mean.  Its
plain version is ``kernels/ref.py::probe_loss_ref``.  The client mesh's
sharded prefix runs it on each rank's probe region
(``fl/pipeline.py::selection_prefix_sharded``), and the seed-batched
sharded prefix (``selection_prefix_seeds_sharded``) on S seeds' regions
in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.probe_fuzzy import (PARAM_SHAPES,
                                             check_probe_operands,
                                             probe_scratch)


def probe_loss_cuda(params, images: torch.Tensor, labels: torch.Tensor,
                    seg: torch.Tensor, counts: torch.Tensor, *,
                    n_clients: int) -> torch.Tensor:
    """Packed probe samples in, (N,) per-client Eq. 7 mean losses out.

    images (S, 28, 28, 1) fp32; labels, seg (S,) int32 (seg ==
    n_clients marks padding rows); counts (N,) int32.  A client with no
    row in ``seg`` gets 0.

    images (seeds, S, 28, 28, 1) give every operand a leading axis of
    seeds (stacked (seeds, ...) weights, counts (seeds, N)); one launch
    takes them all and returns (seeds, N), each seed's row bit-equal to
    a launch of that seed alone."""
    lead, n = tuple(images.shape[:-4]), n_clients
    if len(lead) > 1:
        raise ValueError(f"images: at most one leading (seed) axis, got "
                         f"{tuple(images.shape)}")
    check_probe_operands(params, images, labels, seg, counts, n, lead)
    seeds, s = (lead or (1,))[0], images.shape[len(lead)]
    dev = images.device
    scratch = probe_scratch(s, n, dev, seeds)
    lf = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    lib = build.load("probe_loss")
    build.check(lib.probe_loss_launch(
        seeds, images.data_ptr(), labels.data_ptr(), seg.data_ptr(), s,
        counts.data_ptr(), n, *(params[k].data_ptr() for k in PARAM_SHAPES),
        *(t.data_ptr() for t in scratch), lf.data_ptr(),
        build.stream_ptr(images)), "probe_loss")
    build.LAUNCHES["probe_loss"] += 1
    return lf
