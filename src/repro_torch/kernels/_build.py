"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by hand
with ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. No PyTorch headers are included, so a build takes seconds.
Headers shared by several kernels live beside them as ``csrc/*.cuh``.

The build happens at first use, from the sources in the checkout only, into
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library name carries a hash of its source and of every ``csrc/*.cuh``, so
an edited kernel or header is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits for
them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points and their argument types, by source. Every pointer and the
# stream are c_void_p: ctypes would otherwise pass them as 32-bit ints.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "qgemm": {
        # a, b, sb, sa (nullable), out, scratch (nullable), M, N, K, out_bf16,
        # config, kchunk, splits, stream
        "qgemm_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    },
    "paged_attention": {
        # q, k_pool, v_pool, tables, index, out, partial (nullable),
        # B, H, KV, hd, bs, MB, n_blocks, pool_bf16, splits, per, heads,
        # sm_scale, stream
        "paged_attention_launch": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I,
                                   F, P],
    },
    "qgemm_tile_scales": {
        # a, b, sa, sb, out, M, N, K, narrow, stream
        "qgemm_tile_scales_launch": [P, P, P, P, P, I, I, I, I, P],
    },
    "stencil3x3": {
        # x, w, out, H, W, width, rows, stream
        "stencil3x3_launch": [P, P, P, I, I, I, I, P],
    },
    "qgemv": {
        # x, w, scale, out, B, K, N, rb, tn, cluster, depth, stream
        "qgemv_launch": [P, P, P, P, I, I, I, I, I, I, I, P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas output of each build made by this process, by kernel name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source, of
    every shared header ``csrc/*.cuh`` (any of which it may include) and of
    the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Build every named kernel library that is not built yet, one ``nvcc``
    per source, started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names if not _lib_path(n).exists()]
        for name, out, tmp, proc in started:
            _finish(name, out, tmp, proc)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
