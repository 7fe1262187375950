"""Non-i.i.d. dataset partitioner (paper §6.1) + capacity-grouped storage.

Host-side numpy, bit-equal to ``repro.fl.partition``.

Rules reproduced from the paper:
- each vehicle draws from ``classes_per_client`` classes (9 / 6 / 2 in the
  three Fig. 8 experiments), each class contributing an identical quantity;
- quantity is unbalanced: vehicles 0-11 get ~4500 samples, vehicles 12-29
  get ~45 (Table 3);
- no sample is duplicated across vehicles.

Storage layout: the Table-3 profile is radically quantity-skewed, so
padding every client to the single largest quantity makes small clients
spend ~99% of their local-SGD steps on masked padding rows.
``stack_clients`` therefore buckets clients by capacity (quantity rounded
up to a whole number of batches) and returns one fixed-shape
``ClientGroup`` per distinct capacity — the round engine runs one
batched local trainer per group instead of one trainer over a uniform
max-cap stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np


@dataclass(frozen=True)
class PartitionConfig:
    n_clients: int = 30
    classes_per_client: int = 9
    big_clients: int = 12           # vehicles 0..11
    big_quantity: int = 4500
    small_quantity: int = 45
    num_classes: int = 10
    seed: int = 0


@dataclass(frozen=True)
class ClientGroup:
    """One capacity bucket of the stacked client datasets.

    ``client_ids`` maps the group-local leading axis back to global client
    indices; ``images``/``labels`` are fixed-shape ``(G, cap, ...)`` stacks
    (host ``np.ndarray``; the round engine gathers cohorts from them);
    valid samples occupy the leading ``n_valid[i]`` rows of each client."""
    client_ids: np.ndarray          # (G,) int64, global client indices
    images: Any                     # (G, cap, 28, 28, 1)
    labels: Any                     # (G, cap)
    n_valid: np.ndarray             # (G,) int32
    cap: int

    @property
    def size(self) -> int:
        return len(self.client_ids)


def client_quantities(cfg: PartitionConfig) -> np.ndarray:
    q = np.full(cfg.n_clients, cfg.small_quantity, np.int64)
    q[: cfg.big_clients] = cfg.big_quantity
    return q


def group_capacity(quantity: int, batch_size: int) -> int:
    """Smallest whole number of batches covering ``quantity`` samples —
    always >= ``batch_size``, so every capacity group takes at least one
    local step per epoch (45-sample Table-3 clients included)."""
    q = max(int(quantity), 1)
    return int(np.ceil(q / batch_size) * batch_size)


def steps_per_epoch(cap: int, batch_size: int) -> int:
    """Local SGD steps per epoch at capacity ``cap`` — guarded against 0
    so groups smaller than the batch size still train."""
    return max(1, cap // batch_size)


def partition(images: np.ndarray, labels: np.ndarray,
              cfg: PartitionConfig) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split (images, labels) across clients.  Returns a list of per-client
    (images, labels).  Raises if the source dataset is too small to honor
    the no-duplication rule."""
    rng = np.random.default_rng(cfg.seed + 17)
    pools = {c: list(rng.permutation(np.where(labels == c)[0]))
             for c in range(cfg.num_classes)}
    quantities = client_quantities(cfg)

    out = []
    for i in range(cfg.n_clients):
        # class subset: rotate so coverage is even across clients
        classes = [(i + j) % cfg.num_classes
                   for j in range(cfg.classes_per_client)]
        per_class = int(quantities[i]) // cfg.classes_per_client
        idx: List[int] = []
        for c in classes:
            if len(pools[c]) < per_class:
                raise ValueError(
                    f"class {c} exhausted for client {i}: "
                    f"need {per_class}, have {len(pools[c])}")
            take, pools[c] = pools[c][:per_class], pools[c][per_class:]
            idx.extend(take)
        idx = np.asarray(idx)
        out.append((images[idx], labels[idx]))
    return out


def stack_clients(parts: List[Tuple[np.ndarray, np.ndarray]],
                  batch_size: int = 1,
                  uniform: bool = False) -> List[ClientGroup]:
    """Stack per-client datasets into capacity-grouped fixed-shape tensors.

    Each client's capacity is its quantity rounded up to a whole number of
    batches (``group_capacity``); clients sharing a capacity are stacked
    into one ``ClientGroup``, largest capacity first.  The Table-3 full
    profile (4500 vs 45 samples, batch 20) yields exactly two groups —
    a 4500-cap and a 60-cap one — so small clients train 3 steps/epoch
    instead of 225 steps of mostly masked padding.

    ``uniform=True`` reproduces the single max-capacity stack (every
    client padded to the largest group's cap, one group) — kept as the
    comparison baseline for ``benchmarks/engine_throughput.py``."""
    caps = [group_capacity(len(p[1]), batch_size) for p in parts]
    if uniform:
        caps = [max(caps)] * len(parts)
    groups = []
    for cap in sorted(set(caps), reverse=True):
        ids = np.asarray([i for i, c in enumerate(caps) if c == cap],
                         np.int64)
        im, lb, nv = pad_clients([parts[i] for i in ids], cap)
        groups.append(ClientGroup(client_ids=ids, images=im, labels=lb,
                                  n_valid=nv, cap=cap))
    return groups


def pad_clients(parts: List[Tuple[np.ndarray, np.ndarray]],
                cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-client datasets into fixed-capacity arrays.

    Returns (images (C, cap, 28, 28, 1), labels (C, cap), n_valid (C,)).
    Valid samples occupy the leading positions."""
    c = len(parts)
    img_shape = parts[0][0].shape[1:]
    images = np.zeros((c, cap) + img_shape, np.float32)
    labels = np.zeros((c, cap), np.int32)
    n_valid = np.zeros((c,), np.int32)
    for i, (im, lb) in enumerate(parts):
        n = min(len(lb), cap)
        images[i, :n] = im[:n]
        labels[i, :n] = lb[:n]
        n_valid[i] = n
    return images, labels, n_valid
