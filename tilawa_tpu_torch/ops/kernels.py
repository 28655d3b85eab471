"""The port's hand-written CUDA kernels: build, load and count launches.

Each `csrc/<name>.cu` has a plain `extern "C"` launcher and is compiled by
`nvcc` for sm_90a into its own shared library under the package's ignored
`_build/` directory, at first use, keyed by a hash of its source and the
flags (a changed source builds anew; an unchanged one is reused). The
library is loaded with ctypes. Nothing here runs at import: machines
without nvcc (the CPU test tier) import every module and never build.

The launch counters are plain integers, one per kernel. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("int4_matmul", "log_mel", "int8_matmul")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    cuda_home = os.getenv("CUDA_HOME") or os.getenv("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, out


def build(names: tuple[str, ...] = KERNELS) -> dict[str, dict]:
    """Compile the named kernels that are not built yet, one nvcc each, all
    started together. Returns {name: {"seconds", "log", "path"}}; the log
    holds ptxas' register, shared-memory and spill report. Raises if any
    build fails."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in names}
    report, failed = {}, []
    for name, job in started.items():
        if job is None:
            report[name] = {"seconds": 0.0, "log": "(cached)", "path": str(library_path(name))}
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = {
            "seconds": time.perf_counter() - t0, "log": log, "path": str(out),
        }
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C launcher `symbol` of kernel library `name`, built and loaded on
    first use. Launchers return cudaGetLastError() as an int."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
