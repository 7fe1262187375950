"""Round checkpoints: self-describing, checksummed, atomic snapshots in
the reference's v2 format (``repro.train.checkpoint``).

``save_state`` / ``load_state``: an arbitrary tree of dicts / lists /
tuples / ``None`` / array leaves / Python scalars is flattened to raw
little-endian byte buffers inside one ``arrays.npz`` (every entry stored
as ``uint8`` bytes, keyed ``a000000``, ``a000001``, ... in the order a
depth-first walk meets the leaves, dicts in key order) and a JSON
``manifest.json`` holding
the skeleton (container kinds ``none`` / ``dict`` / ``tuple`` / ``list``
/ ``leaf``; each leaf's dtype name, shape and Python-scalar tag
``bool`` / ``int`` / ``float``), a sha256 of the array file and an
arbitrary JSON ``extra``.  The files are the reference's byte layout and
names, so each package loads the other's snapshots.

Leaves may be numpy arrays, Python or numpy scalars, or torch tensors on
any device (a CUDA tensor is copied to the host).  They load back as
numpy arrays and Python scalars, except ``bfloat16`` leaves, which load
as CPU ``torch.bfloat16`` tensors (decoded through ``torch.frombuffer``)
because numpy has no bfloat16 without ``ml_dtypes``; their bytes are
the saved bytes either way.

Write order is the durability contract: ``arrays.npz`` is written
atomically first (``ioutil.write_atomic``), the manifest, which carries
the checksum, atomically last.  The manifest is the commit point: a kill
between the two leaves an array file without a manifest, which readers
treat as "no checkpoint here", and any later corruption of the array
payload fails the checksum.  A torn or corrupt snapshot is detected and
never loaded (``CheckpointCorruptError``).

``RoundCheckpointer`` manages a directory of per-round snapshots for
the round drivers (``fl/rounds.py``, ``fl/async_server.py``, the
sweep's seed groups): ``save_round`` writes ``round_NNNNNN/`` and prunes
rounds beyond ``keep``; ``latest_good`` walks the rounds newest first,
skipping a corrupt or half-written snapshot with a
``CheckpointCorruptWarning``, until one loads.

``save_checkpoint`` / ``load_checkpoint``: the legacy (params,
optimizer state, step) API of LM training, on the v2 format.  The
reference checks JAX ``PyTreeDef`` strings; the port stores each tree's
leaves as (key path, shape, dtype) rows and checks them against the
restore template's, then every leaf's shape and dtype again while
rebuilding, and raises on any mismatch, never casting.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ioutil import sha256_file, write_atomic, write_atomic_json

FORMAT_VERSION = 2

_ARRAYS = "arrays.npz"
_MANIFEST = "manifest.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists but fails validation (missing pieces, bad
    checksum, undecodable skeleton): refuse to load it."""


class CheckpointCorruptWarning(RuntimeWarning):
    """A corrupt snapshot was detected and skipped (``latest_good``)."""


# -- the v2 state format ---------------------------------------------------

def _leaf_bytes(node: Any) -> Tuple[bytes, str, List[int]]:
    """A leaf's raw bytes, the reference's dtype name and its shape."""
    if torch.is_tensor(node):
        t = node.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), "bfloat16",
                    list(t.shape))
        node = t.numpy()
    arr = np.asarray(node)
    if arr.dtype == object:
        raise TypeError(f"cannot checkpoint object-dtype leaf: {node!r}")
    return (np.ascontiguousarray(arr).tobytes(), str(arr.dtype),
            list(arr.shape))


def _encode(node: Any, flat: Dict[str, np.ndarray],
            counter: List[int]) -> Dict[str, Any]:
    """Encode a tree node into a JSON skeleton, collecting the leaves'
    bytes into ``flat``."""
    if node is None:
        return {"kind": "none"}
    if isinstance(node, dict):
        # in key order, as the reference's (``jax.device_get`` rebuilds
        # a dict with its keys sorted), so the leaves number alike
        return {"kind": "dict",
                "items": {str(k): _encode(node[k], flat, counter)
                          for k in sorted(node, key=str)}}
    if isinstance(node, tuple):
        return {"kind": "tuple",
                "items": [_encode(v, flat, counter) for v in node]}
    if isinstance(node, list):
        return {"kind": "list",
                "items": [_encode(v, flat, counter) for v in node]}
    py = None
    if isinstance(node, bool):
        py = "bool"
    elif isinstance(node, int):
        py = "int"
    elif isinstance(node, float):
        py = "float"
    raw, dtype, shape = _leaf_bytes(node)
    key = f"a{counter[0]:06d}"
    counter[0] += 1
    flat[key] = np.frombuffer(raw, dtype=np.uint8)
    return {"kind": "leaf", "key": key, "dtype": dtype, "shape": shape,
            "py": py}


def _decode(skel: Dict[str, Any], flat: Dict[str, np.ndarray]) -> Any:
    kind = skel["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _decode(v, flat) for k, v in skel["items"].items()}
    if kind == "tuple":
        return tuple(_decode(v, flat) for v in skel["items"])
    if kind == "list":
        return [_decode(v, flat) for v in skel["items"]]
    if kind != "leaf":
        raise CheckpointCorruptError(f"unknown skeleton kind {kind!r}")
    raw = flat[skel["key"]].tobytes()
    if skel["dtype"] == "bfloat16":
        if not raw:
            return torch.empty(skel["shape"], dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16
                                ).reshape(skel["shape"])
    arr = np.frombuffer(raw, dtype=np.dtype(skel["dtype"]))
    arr = arr.reshape(skel["shape"])
    py = skel.get("py")
    if py == "bool":
        return bool(arr.reshape(()))
    if py == "int":
        return int(arr.reshape(()))
    if py == "float":
        return float(arr.reshape(()))
    return arr


def save_state(path: str, state: Any,
               extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically snapshot ``state`` under directory ``path``.

    ``extra`` is a JSON-serialisable sidecar (rows, round indices)
    stored in the manifest and returned verbatim by ``load_state``.  The
    manifest write is the commit point (module docstring)."""
    os.makedirs(path, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    skeleton = _encode(state, flat, [0])
    buf = io.BytesIO()
    np.savez(buf, **flat)
    write_atomic(os.path.join(path, _ARRAYS), buf.getvalue())
    manifest = {"format_version": FORMAT_VERSION,
                "skeleton": skeleton,
                "arrays_sha256": sha256_file(os.path.join(path, _ARRAYS)),
                "extra": extra if extra is not None else {}}
    write_atomic_json(os.path.join(path, _MANIFEST), manifest, indent=1)


def load_state(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load and verify a ``save_state`` snapshot -> ``(state, extra)``.

    Raises ``CheckpointCorruptError`` on any integrity failure: a
    missing manifest or array file, a checksum mismatch (a torn or
    corrupted payload), a format version other than 2, or an
    undecodable skeleton."""
    man_path = os.path.join(path, _MANIFEST)
    arr_path = os.path.join(path, _ARRAYS)
    if not os.path.exists(man_path):
        raise CheckpointCorruptError(
            f"{path}: no manifest (half-written or not a checkpoint)")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}")
    if manifest.get("format_version") != FORMAT_VERSION:
        raise CheckpointCorruptError(
            f"{path}: unsupported format_version "
            f"{manifest.get('format_version')!r} (want {FORMAT_VERSION})")
    if not os.path.exists(arr_path):
        raise CheckpointCorruptError(f"{path}: missing {_ARRAYS}")
    digest = sha256_file(arr_path)
    if digest != manifest.get("arrays_sha256"):
        raise CheckpointCorruptError(
            f"{path}: checksum mismatch for {_ARRAYS} (stored "
            f"{manifest.get('arrays_sha256')!r}, computed {digest!r}): "
            f"torn or corrupted checkpoint")
    try:
        with np.load(arr_path) as data:
            flat = {k: data[k] for k in data.files}
        state = _decode(manifest["skeleton"], flat)
    except (KeyError, TypeError, ValueError, OSError, RuntimeError) as e:
        raise CheckpointCorruptError(f"{path}: undecodable payload: {e}")
    return state, manifest.get("extra", {})


def is_valid_checkpoint(path: str) -> bool:
    """Full integrity probe (manifest, checksum, decode)."""
    try:
        load_state(path)
        return True
    except CheckpointCorruptError:
        return False


# -- the legacy (params, opt_state, step) API --------------------------------

def _spec(tree: Any, path: str = "") -> List[List[Any]]:
    """[key path, shape, dtype name] of every leaf, depth first, dicts in
    key order."""
    if isinstance(tree, dict):
        return [row for k in sorted(tree, key=str)
                for row in _spec(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [row for i, v in enumerate(tree)
                for row in _spec(v, f"{path}/{i}")]
    if tree is None:
        return [[path, None, None]]
    if torch.is_tensor(tree):
        return [[path, list(tree.shape), str(tree.dtype)[len("torch."):]]]
    _, dtype, shape = _leaf_bytes(tree)
    return [[path, shape, dtype]]


def save_checkpoint(path: str, params: Any, opt_state: Optional[Any] = None,
                    step: int = 0, extra: Optional[Dict] = None) -> None:
    """Snapshot ``(params, opt_state, step)`` under directory ``path``
    (atomic, checksummed: the module docstring), with each tree's leaf
    rows for ``load_checkpoint``'s check."""
    state = {"params": params}
    if opt_state is not None:
        state["opt"] = opt_state
    meta = {"step": int(step), "extra": extra or {},
            "params_spec": _spec(params)}
    if opt_state is not None:
        meta["opt_spec"] = _spec(opt_state)
    save_state(path, state, extra=meta)


def _restore_like(like: Any, got: Any, path: str) -> Any:
    """``got`` (a decoded v2 state) rebuilt in the template's containers,
    each leaf a tensor on the template leaf's device; the structure,
    shape and dtype checked at every leaf, a mismatch raising with the
    leaf's key path."""
    where = path or "<root>"
    if like is None:
        if got is not None:
            raise ValueError(f"structure mismatch at {where}: the "
                             f"checkpoint has a value where the template "
                             f"has None")
        return None
    if isinstance(like, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(
                str(k) for k in like):
            raise ValueError(
                f"structure mismatch at {where}: template keys "
                f"{sorted(str(k) for k in like)} vs checkpoint "
                f"{sorted(got) if isinstance(got, dict) else type(got)}")
        return {k: _restore_like(v, got[str(k)], f"{path}/{k}")
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(got) != len(like):
            raise ValueError(f"structure mismatch at {where}: template "
                             f"{type(like).__name__} of {len(like)} vs "
                             f"checkpoint {type(got).__name__}")
        return type(like)(_restore_like(v, g, f"{path}/{i}")
                          for i, (v, g) in enumerate(zip(like, got)))
    want = like if torch.is_tensor(like) else torch.as_tensor(like)
    t = got if torch.is_tensor(got) else torch.from_numpy(np.array(got))
    if tuple(t.shape) != tuple(want.shape):
        raise ValueError(f"shape mismatch for {where}: checkpoint "
                         f"{tuple(t.shape)} vs template {tuple(want.shape)}")
    if t.dtype != want.dtype:
        raise ValueError(f"dtype mismatch for {where}: checkpoint {t.dtype} "
                         f"vs template {want.dtype} (refusing to cast)")
    return t.to(want.device)


def load_checkpoint(path: str, params_like: Any,
                    opt_like: Optional[Any] = None
                    ) -> Tuple[Any, Optional[Any], int]:
    """Restore ``(params, opt_state, step)`` into the structure of the
    templates.  On top of the v2 integrity checks (manifest, checksum),
    the stored leaf rows (key path, shape, dtype) must equal the
    template's, and every leaf's shape and dtype are checked again while
    rebuilding; any mismatch raises ``ValueError``."""
    state, meta = load_state(path)
    for key, like in (("params_spec", params_like), ("opt_spec", opt_like)):
        stored = meta.get(key)
        if like is None or stored is None:
            continue
        want = _spec(like)
        if stored != want:
            bad = next((f"{a} vs template {b}" for a, b in zip(stored, want)
                        if a != b), f"{len(stored)} leaves vs template "
                                    f"{len(want)}")
            raise ValueError(f"{key[:-5]} structure mismatch: checkpoint "
                             f"{bad}")
    params = _restore_like(params_like, state["params"], "params")
    opt_state = None
    if opt_like is not None:
        if "opt" not in state:
            raise ValueError("checkpoint has no opt state but opt_like "
                             "was provided")
        opt_state = _restore_like(opt_like, state["opt"], "opt")
    return params, opt_state, int(meta["step"])


# -- per-round snapshots ---------------------------------------------------

_ROUND_RE = re.compile(r"^round_(\d{6,})$")


class RoundCheckpointer:
    """A directory of per-round ``save_state`` snapshots with a cadence,
    retention and corrupt-skip recovery.

    Layout: ``directory/round_NNNNNN/{arrays.npz,manifest.json}``.  A
    kill mid-save or a corrupted payload costs at most the rounds since
    the previous good snapshot, never a silent load of bad state."""

    def __init__(self, directory: str, every: int = 1, keep: int = 3):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1: {every}")
        if keep < 1:
            raise ValueError(f"checkpoint keep must be >= 1: {keep}")
        self.directory = os.fspath(directory)
        self.every = int(every)
        self.keep = int(keep)

    def due(self, rnd: int) -> bool:
        """True when round ``rnd`` (0-based) ends a cadence window."""
        return (rnd + 1) % self.every == 0

    def path_for(self, rnd: int) -> str:
        return os.path.join(self.directory, f"round_{rnd:06d}")

    def rounds_on_disk(self) -> List[int]:
        """Round indices with snapshot directories, ascending (no
        integrity check)."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            m = _ROUND_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def save_round(self, rnd: int, state: Any,
                   extra: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot round ``rnd`` and prune snapshots beyond ``keep``."""
        path = self.path_for(rnd)
        save_state(path, state, extra=extra)
        for old in self.rounds_on_disk()[:-self.keep]:
            shutil.rmtree(self.path_for(old), ignore_errors=True)
        return path

    def latest_good(self) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """``(round, state, extra)`` of the newest snapshot that passes
        the integrity checks, skipping corrupt ones with a warning;
        ``None`` when no good snapshot exists."""
        for rnd in reversed(self.rounds_on_disk()):
            try:
                state, extra = load_state(self.path_for(rnd))
                return rnd, state, extra
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"skipping corrupt checkpoint {self.path_for(rnd)}: "
                    f"{e}", CheckpointCorruptWarning, stacklevel=2)
        return None

    def clear(self) -> None:
        """Remove every snapshot (a finished run owes the disk nothing)."""
        if os.path.isdir(self.directory):
            shutil.rmtree(self.directory, ignore_errors=True)
