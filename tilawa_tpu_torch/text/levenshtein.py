"""Edit-distance primitives: ctypes binding to the native C++ core.

Public API (semantics chosen for parity with the reference stack):

  distance(a, b)            classic Levenshtein distance
                            (reference: web/frontend/src/lib/levenshtein.ts:5-34)
  ratio(a, b)               python-Levenshtein-compatible similarity
                            (lensum - indel_distance) / lensum == 2*LCS/lensum;
                            this is what every threshold in the reference's
                            Python pipeline was tuned against
                            (reference: shared/quran_db.py:6)
  semi_global_distance(q,r) whole query vs best substring of ref
                            (reference: lib/levenshtein.ts:54-73)
  fragment_score(q, r)      1 - semi_global/len(q)  (lib/levenshtein.ts:80-83)
  batch_ratio / batch_fragment_score / batch_distance
                            one query against a prepared corpus, scored in
                            native threads — the retrieval hot loop.

The native library is compiled on demand from native/edlib.cpp (g++ -O3)
into the package's ignored _build/ directory; a pure-Python fallback keeps
everything working without a toolchain (slower, same results).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "edlib.cpp"
_LIB_PATH = Path(__file__).resolve().parent.parent / "_build" / "_edlib.so"

_lib = None
_lib_lock = threading.Lock()
_NUM_THREADS = int(os.getenv("TILAWA_EDLIB_THREADS", str(min(8, os.cpu_count() or 4))))


def _build_native() -> bool:
    # build beside the target and rename, so concurrent processes never load
    # a half-written library
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            str(_SRC), "-o", str(tmp),
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib if _lib is not False else None
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        if os.getenv("TILAWA_EDLIB_DISABLE"):
            _lib = False
            return None
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build_native():
                _lib = False
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _lib = False
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        for name in ("lev_distance", "indel_distance", "semi_global_distance"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
        for name in ("lev_ratio", "partial_ratio"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_double
            fn.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
        lib.batch_scan.restype = None
        lib.batch_scan.argtypes = [
            ctypes.c_int, u32p, ctypes.c_int, u32p, i64p,
            ctypes.c_int, ctypes.c_int, f64p,
        ]
        lib.batch_scan_subset.restype = None
        lib.batch_scan_subset.argtypes = [
            ctypes.c_int, u32p, ctypes.c_int, u32p, i64p, i64p,
            ctypes.c_int, ctypes.c_int, f64p,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def _u32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


# ---------------------------------------------------------------- pure Python

def _py_distance(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(a) > len(b):
        a, b = b, a
    prev = list(range(len(a) + 1))
    for j, cb in enumerate(b, 1):
        curr = [j] + [0] * len(a)
        for i, ca in enumerate(a, 1):
            curr[i] = min(prev[i] + 1, curr[i - 1] + 1, prev[i - 1] + (ca != cb))
        prev = curr
    return prev[-1]


def _py_indel(a: str, b: str) -> int:
    if not a or not b:
        return len(a) + len(b)
    if len(a) > len(b):
        a, b = b, a
    prev = [0] * (len(a) + 1)
    for cb in b:
        curr = [0] * (len(a) + 1)
        for i, ca in enumerate(a, 1):
            curr[i] = prev[i - 1] + 1 if ca == cb else max(prev[i], curr[i - 1])
        prev = curr
    return len(a) + len(b) - 2 * prev[-1]


def _py_semi_global(q: str, r: str) -> int:
    if not q:
        return 0
    if not r:
        return len(q)
    prev = list(range(len(q) + 1))
    best = prev[-1]
    for cr in r:
        curr = [0] + [0] * len(q)
        for i, cq in enumerate(q, 1):
            curr[i] = min(prev[i] + 1, curr[i - 1] + 1, prev[i - 1] + (cq != cr))
        best = min(best, curr[-1])
        prev = curr
    return best


# ------------------------------------------------------------------- public

def distance(a: str, b: str) -> int:
    lib = _load()
    if lib is None:
        return _py_distance(a, b)
    ca, cb = _codes(a), _codes(b)
    return lib.lev_distance(_u32p(ca), len(ca), _u32p(cb), len(cb))


def indel_distance(a: str, b: str) -> int:
    lib = _load()
    if lib is None:
        return _py_indel(a, b)
    ca, cb = _codes(a), _codes(b)
    return lib.indel_distance(_u32p(ca), len(ca), _u32p(cb), len(cb))


def ratio(a: str, b: str) -> float:
    lensum = len(a) + len(b)
    if lensum == 0:
        return 1.0
    lib = _load()
    if lib is None:
        return (lensum - _py_indel(a, b)) / lensum
    ca, cb = _codes(a), _codes(b)
    return lib.lev_ratio(_u32p(ca), len(ca), _u32p(cb), len(cb))


def partial_ratio(short: str, long: str) -> float:
    """Best ratio() of the shorter string against its best same-length window
    in the longer string (reference: shared/quran_db.py:10-28)."""
    if not short or not long:
        return 0.0
    lib = _load()
    if lib is None:
        if len(short) > len(long):
            short, long = long, short
        window = len(short)
        best = 0.0
        for i in range(max(1, len(long) - window + 1)):
            r = ratio(short, long[i : i + window])
            if r > best:
                best = r
                if best >= 1.0:
                    break
        return best
    ca, cb = _codes(short), _codes(long)
    return lib.partial_ratio(_u32p(ca), len(ca), _u32p(cb), len(cb))


def semi_global_distance(query: str, ref: str) -> int:
    lib = _load()
    if lib is None:
        return _py_semi_global(query, ref)
    cq, cr = _codes(query), _codes(ref)
    return lib.semi_global_distance(_u32p(cq), len(cq), _u32p(cr), len(cr))


def fragment_score(query: str, ref: str) -> float:
    if not query:
        return 1.0
    return max(0.0, 1.0 - semi_global_distance(query, ref) / len(query))


class Corpus:
    """A concatenated, pre-encoded set of strings for batched native scans."""

    __slots__ = ("texts", "_flat", "_offsets")

    def __init__(self, texts: list[str]):
        self.texts = list(texts)
        codes = [_codes(t) for t in self.texts]
        self._flat = (
            np.concatenate(codes) if codes else np.empty(0, dtype=np.uint32)
        )
        lens = np.array([len(c) for c in codes], dtype=np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    def __len__(self) -> int:
        return len(self.texts)

    def _scan(self, kind: int, query: str) -> np.ndarray:
        n = len(self.texts)
        out = np.empty(n, dtype=np.float64)
        if n == 0:
            return out
        lib = _load()
        cq = _codes(query)
        if lib is not None:
            lib.batch_scan(
                kind, _u32p(cq), len(cq),
                _u32p(self._flat),
                self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, _NUM_THREADS,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            return out
        for i, t in enumerate(self.texts):
            if kind == 0:
                out[i] = _py_distance(query, t)
            elif kind == 1:
                lensum = len(query) + len(t)
                out[i] = (lensum - _py_indel(query, t)) / lensum if lensum else 1.0
            elif kind == 2:
                out[i] = (
                    max(0.0, 1.0 - _py_semi_global(query, t) / len(query))
                    if query else 1.0
                )
            else:
                out[i] = partial_ratio(query, t)
        return out

    def batch_distance(self, query: str) -> np.ndarray:
        return self._scan(0, query)

    def batch_ratio(self, query: str) -> np.ndarray:
        return self._scan(1, query)

    def batch_fragment_score(self, query: str) -> np.ndarray:
        return self._scan(2, query)

    def batch_partial_ratio(self, query: str) -> np.ndarray:
        return self._scan(3, query)

    def _scan_subset(self, kind: int, query: str, indices: np.ndarray) -> np.ndarray:
        """Score only the named corpus rows; returns array aligned with
        `indices`."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty(len(idx), dtype=np.float64)
        if len(idx) == 0:
            return out
        lib = _load()
        if lib is not None:
            cq = _codes(query)
            lib.batch_scan_subset(
                kind, _u32p(cq), len(cq),
                _u32p(self._flat),
                self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(idx), _NUM_THREADS,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            return out
        full = self._scan(kind, query)
        return full[idx]

    def subset_partial_ratio(self, query: str, indices: np.ndarray) -> np.ndarray:
        return self._scan_subset(3, query, indices)

    def subset_ratio(self, query: str, indices: np.ndarray) -> np.ndarray:
        return self._scan_subset(1, query, indices)
