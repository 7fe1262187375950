"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries land in
``build/repro_torch/`` at the repository root, named by a digest of the
sources and flags, so an edited source never loads a stale library.
``build_all`` starts one ``nvcc`` per source at once.  Nothing is
compiled at import time.

``LAUNCHES`` counts the kernel launches of each wrapper: a wrapper adds
one where it launches its kernel and nowhere else (one per call, also
where a call runs more than one CUDA kernel, as ``wkv6`` past one time
chunk, ``flash_attention_bwd`` (its dQ kernel, its dK/dV kernel and,
where the plan splits a kv tile, the sum of its partials), ``wkv6_bwd``
(its rows and columns kernels, past one time chunk the carry, and the
carry terms with du's sum) and ``selective_scan_bwd`` (each chunk's
forward walk, past one chunk the carry, each chunk's sweep back, and the
ordered sums of its partials) do, and
where one call takes several seeds, as the sweep's
seed-batched ``probe_fuzzy`` and ``neighbor_elect`` do), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("probe_fuzzy", "fuzzy_eval", "neighbor_elect", "windowed_counts",
           "wkv6", "flash_attention", "selective_scan", "probe_loss",
           "cohort_gemm", "flash_attention_bwd", "wkv6_bwd",
           "selective_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

# C signatures: argument kinds in order (p = pointer/stream, i = int,
# l = 64-bit int, f = float); every function returns a cudaError_t as int
_SIGNATURES = {
    "probe_fuzzy": {"probe_fuzzy_launch": "ipppipppippppppppppppippppppppp"},
    "fuzzy_eval": {"fuzzy_eval_launch": "piiipppp",
                   "fuzzy_eval_scratch_floats": ""},
    "neighbor_elect": {"neighbor_elect_launch": "ippiffipp"},
    "windowed_counts": {"windowed_counts_launch": "pppiiiffipp"},
    "wkv6": {"wkv6_launch": "ppppppiiiiipppp"},
    "flash_attention": {"flash_attention_launch": "pppppiiiiiiiiiifp"},
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": "pppppppppppliiiiiiiiiiiifp"},
    "wkv6_bwd": {"wkv6_bwd_launch": "pppppppppiiiiipppppppp"},
    "selective_scan": {"selective_scan_launch": "ppppppiiiiipppp"},
    "selective_scan_bwd": {
        "selective_scan_bwd_launch": "pppppppppiiiiipppppppp"},
    "probe_loss": {"probe_loss_launch": "ipppipipppppppppppppppp"},
    "cohort_gemm": {"cohort_gemm_launch": "pp"},
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
          "f": ctypes.c_float}

LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the build of ``name``'s current sources, if built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Raises with nvcc's output if any build fails."""
    names = tuple(names or KERNELS)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = out[n].with_name(out[n].name + f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, sig in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = [_CTYPE[c] for c in sig]
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as the raw handle (the
    query ``torch.cuda.current_stream`` wraps, without building a Stream
    object each call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype
            ) -> None:
    """A kernel operand's contract: on CUDA, of ``dtype`` and ``shape``
    (``None`` entries match any size), contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
