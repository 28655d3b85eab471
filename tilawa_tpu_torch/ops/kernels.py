"""The port's hand-written CUDA kernels: build, load and count launches.

Each `csrc/<name>.cu` has plain `extern "C"` launchers and is compiled by
`nvcc` for sm_90a into its own shared library under the package's ignored
`_build/` directory, at first use, keyed by a hash of its source, of every
header it includes from `csrc/` and of the flags (a changed source or
header builds anew; an unchanged one is reused). The
library is loaded with ctypes. Nothing here runs at import: machines
without nvcc (the CPU test tier) import every module and never build.

The launch counters are plain integers, one per kernel. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.

The inference kernels compute forward only: a wrapper handed a tensor that
needs a gradient under grad mode raises (forward_only), on every device,
rather than return an output with no grad_fn that would silently drop the
gradient. The training loss (ops/ctc.py ctc_loss) is an autograd Function
whose backward is a kernel of its own library; it counts a launch for its
forward and one for its backward. A wrapper handed a DTensor raises
(plain_tensors), rather than run on its local part silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("int4_matmul", "log_mel", "int8_matmul", "ctc_lattice", "ctc_loss")

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` and the local headers it includes, transitively."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
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


def plain_tensors(what: str, *tensors) -> None:
    """Raise if an input is a DTensor: a kernel reads plain memory through
    ctypes, so a sharded caller hands it its local part itself."""
    if any(hasattr(t, "to_local") for t in tensors):
        raise TypeError(f"{what} takes plain tensors, not a DTensor: a sharded caller "
                        "passes its local part (DTensor.to_local())")


def forward_only(what: str, *tensors) -> None:
    """Raise if an input is a DTensor (plain_tensors), or if autograd would
    need a gradient through a kernel's inputs."""
    plain_tensors(what, *tensors)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} computes forward only and has no backward: an input requires a "
            "gradient under grad mode (run it under torch.no_grad(), or train the "
            "dequantized model)"
        )


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
