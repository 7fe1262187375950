"""Fused Eq. 7 probe -> Eq. 8 -> Mamdani on the card (replaces
``repro/kernels/probe_fuzzy.py::probe_fuzzy_pallas``).

``probe_fuzzy_cuda`` launches the five phases of ``csrc/probe_fuzzy.cu``
on one stream; its plain version is ``kernels/ref.py::probe_fuzzy_ref``.
The wrapper allocates the phases' scratch: the (S, 3136) activation,
the (S, 512) hidden layer, (S,) losses and (N,) per-client sums.
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
    [SQ, TA, CC]; col_maxima optional (4,) external Eq. 8 maxima."""
    s, n = images.shape[0], n_clients
    build.require(images, "images", (None, 28, 28, 1), torch.float32)
    build.require(labels, "labels", (s,), torch.int32)
    build.require(seg, "seg", (s,), torch.int32)
    build.require(counts, "counts", (n,), torch.int32)
    build.require(aux, "aux", (n, 3), torch.float32)
    for name, shape in PARAM_SHAPES.items():
        build.require(params[name], name, shape, torch.float32)
    if col_maxima is not None:
        build.require(col_maxima, "col_maxima", (4,), torch.float32)
    if s == 0 or n == 0:
        raise ValueError("probe_fuzzy needs at least one sample and client")
    dev = images.device
    rules = mamdani_operands(means, sigmas, level_centers, rule_table,
                             rule_levels, dev)
    act = torch.empty(s, 3136, dtype=torch.float32, device=dev)
    hidden = torch.empty(s, 512, dtype=torch.float32, device=dev)
    losses = torch.empty(s, dtype=torch.float32, device=dev)
    sums = torch.empty(n, dtype=torch.float32, device=dev)
    feats = torch.empty(n, 4, dtype=torch.float32, device=dev)
    evals = torch.empty(n, dtype=torch.float32, device=dev)
    lib = build.load("probe_fuzzy")
    p = [params[k].data_ptr() for k in PARAM_SHAPES]
    build.check(lib.probe_fuzzy_launch(
        images.data_ptr(), labels.data_ptr(), seg.data_ptr(), s,
        counts.data_ptr(), aux.data_ptr(),
        col_maxima.data_ptr() if col_maxima is not None else None, n,
        *p, means.data_ptr(), sigmas.data_ptr(), level_centers.data_ptr(),
        rules.data_ptr(), rules.shape[0], act.data_ptr(), hidden.data_ptr(),
        losses.data_ptr(), sums.data_ptr(), feats.data_ptr(),
        evals.data_ptr(), build.stream_ptr(images)), "probe_fuzzy")
    build.LAUNCHES["probe_fuzzy"] += 1
    return feats, evals
