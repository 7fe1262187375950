"""Fused Eq. 7 probe -> Eq. 8 -> Mamdani on the card (replaces
``repro/kernels/probe_fuzzy.py::probe_fuzzy_pallas``).

``probe_fuzzy_cuda`` launches the six phases of ``csrc/probe_fuzzy.cu``
(the first five shared with ``probe_loss`` in ``csrc/probe_phases.cuh``;
conv2 and fc1 as split-precision TF32 products on the tensor cores)
on one stream; its plain version is ``kernels/ref.py::probe_fuzzy_ref``.
Operands with a leading axis of seeds (the sweep's seed-batched prefix)
run in the same one launch.  The wrapper allocates the phases' scratch
(``probe_scratch``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.fuzzy_eval import mamdani_operands

# the CNN the kernel is compiled for (configs/mnist_cnn.py)
PARAM_SHAPES = {"conv1.w": (32, 1, 5, 5), "conv1.b": (32,),
                "conv2.w": (64, 32, 5, 5), "conv2.b": (64,),
                "fc1.w": (512, 3136), "fc1.b": (512,),
                "fc2.w": (10, 512), "fc2.b": (10,)}


def check_probe_operands(params, images, labels, seg, counts,
                         n_clients: int, lead: tuple = ()) -> None:
    """The probe's contract, shared by ``probe_fuzzy`` and
    ``probe_loss``: images (S, 28, 28, 1) fp32; labels, seg (S,) int32
    (seg == n_clients marks padding rows); counts (N,) int32; the CNN's
    fp32 weights.  With ``lead`` = (seeds,), every operand has that
    leading axis (stacked (seeds, ...) weights)."""
    s = images.shape[len(lead)]
    build.require(images, "images", lead + (None, 28, 28, 1), torch.float32)
    build.require(labels, "labels", lead + (s,), torch.int32)
    build.require(seg, "seg", lead + (s,), torch.int32)
    build.require(counts, "counts", lead + (n_clients,), torch.int32)
    for name, shape in PARAM_SHAPES.items():
        build.require(params[name], name, lead + shape, torch.float32)
    if s == 0 or n_clients == 0 or 0 in lead:
        raise ValueError("the probe needs at least one sample, client and "
                         "seed")


# conv2's and fc1's weights split into TF32 hi and lo parts (phase 0)
WSPLIT_FLOATS = 2 * 64 * 800 + 2 * 512 * 3136


def probe_scratch(s: int, n: int, dev, seeds: int = 1
                  ) -> Tuple[torch.Tensor, ...]:
    """Scratch of phases 0-4, seed-major for ``seeds`` seeds: the split
    weights, the (S, 3136) activation, the (S, 512) hidden layer, (S,)
    losses, each client's first and last row (2N,) int32 and (N,)
    per-client sums."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(seeds * WSPLIT_FLOATS, **f32),
            torch.empty(seeds, s, 3136, **f32),
            torch.empty(seeds, s, 512, **f32),
            torch.empty(seeds, s, **f32),
            torch.empty(2 * seeds * n, dtype=torch.int32, device=dev),
            torch.empty(seeds, n, **f32))


def probe_fuzzy_cuda(params, images: torch.Tensor, labels: torch.Tensor,
                     seg: torch.Tensor, counts: torch.Tensor,
                     aux: torch.Tensor, means: torch.Tensor,
                     sigmas: torch.Tensor, rule_table: np.ndarray,
                     rule_levels: np.ndarray, level_centers: torch.Tensor,
                     *, n_clients: int,
                     col_maxima: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed probe samples in, ``(feats (N, 4), evals (N,))`` out.

    images (S, 28, 28, 1) fp32; labels, seg (S,) int32 (seg ==
    n_clients marks padding rows); counts (N,) int32; aux (N, 3) raw
    [SQ, TA, CC]; col_maxima optional (4,) external Eq. 8 maxima.

    images (seeds, S, 28, 28, 1) give every operand but the Mamdani set
    a leading axis of seeds (stacked (seeds, ...) weights, col_maxima
    (seeds, 4)); one launch takes them all and returns ``(feats (seeds,
    N, 4), evals (seeds, N))``, each seed's Eq. 8 over its own N clients
    and bit-equal to a launch of that seed alone."""
    lead, n = tuple(images.shape[:-4]), n_clients
    if len(lead) > 1:
        raise ValueError(f"images: at most one leading (seed) axis, got "
                         f"{tuple(images.shape)}")
    check_probe_operands(params, images, labels, seg, counts, n, lead)
    build.require(aux, "aux", lead + (n, 3), torch.float32)
    if col_maxima is not None:
        build.require(col_maxima, "col_maxima", lead + (4,), torch.float32)
    seeds, s = (lead or (1,))[0], images.shape[len(lead)]
    dev = images.device
    rules = mamdani_operands(means, sigmas, level_centers, rule_table,
                             rule_levels, dev)
    scratch = probe_scratch(s, n, dev, seeds)
    feats = torch.empty(lead + (n, 4), dtype=torch.float32, device=dev)
    evals = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    lib = build.load("probe_fuzzy")
    p = [params[k].data_ptr() for k in PARAM_SHAPES]
    build.check(lib.probe_fuzzy_launch(
        seeds, images.data_ptr(), labels.data_ptr(), seg.data_ptr(), s,
        counts.data_ptr(), aux.data_ptr(),
        col_maxima.data_ptr() if col_maxima is not None else None, n,
        *p, means.data_ptr(), sigmas.data_ptr(), level_centers.data_ptr(),
        rules.data_ptr(), rules.shape[0], *(t.data_ptr() for t in scratch),
        feats.data_ptr(), evals.data_ptr(), build.stream_ptr(images)),
        "probe_fuzzy")
    build.LAUNCHES["probe_fuzzy"] += 1
    return feats, evals
