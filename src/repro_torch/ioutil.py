"""Atomic file writes: a temporary file beside the target + ``os.replace``.

The port's copy of the reference's ``write_atomic``,
``write_atomic_json`` and ``sha256_file`` (the checkpoint manifest's
checksum, ``train/checkpoint.py``).  The payload lands in a temporary file in the
target's directory, is fsync'd, and is renamed over the target in one
``os.replace``, so a reader sees either the complete old file or the
complete new one; a process killed mid-write leaves at most a stray
``*.tmp-*`` file, never a torn target.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Union


def write_atomic(path: Union[str, os.PathLike], data: Union[str, bytes],
                 *, sync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically (tmp file + ``os.replace``).

    The temporary file lives in the target's directory so the final
    rename never crosses a filesystem boundary.  On any failure the
    temporary file is removed and the previous ``path`` contents (if
    any) are left untouched."""
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    payload = data.encode("utf-8") if isinstance(data, str) else data
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            if sync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_atomic_json(path: Union[str, os.PathLike], obj: Any,
                      **json_kwargs: Any) -> None:
    """``json.dumps`` through ``write_atomic`` (one serialized payload,
    one rename)."""
    write_atomic(path, json.dumps(obj, **json_kwargs))


def sha256_file(path: Union[str, os.PathLike],
                chunk_bytes: int = 1 << 20) -> str:
    """Hex sha256 of a file's contents (streamed)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()
