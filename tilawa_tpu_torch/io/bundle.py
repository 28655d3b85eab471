"""Export bundle reader and writer: `config.json` + flax-msgpack
`variables.msgpack`.

Counterpart of tilawa_tpu/train/checkpoint.py (load_variables,
shipped_checkpoint) without flax or the `msgpack` package: a small
pure-Python decoder for the msgpack subset flax writes — maps, str, bin,
ints, floats, arrays, nil/bool and ext type 1, flax's ndarray (a nested
msgpack `(shape, dtype-name, bytes)`, flax.serialization._ndarray_from_bytes).
Binary payloads are decoded as memoryview slices of the file buffer, so the
arrays are zero-copy views and a 70 MB bundle decodes in well under a second.
Maps keep the file's key order.

`packb` encodes the same subset the way msgpack-python does for flax
(`msgpack.packb(tree, use_bin_type=True)`, ndarrays as ext type 1 holding
`packb((shape, dtype-name, bytes))`): the smallest encoding of every int,
floats as float64, str/bin/map/array/ext in their smallest forms, maps in
the dict's own key order. So `packb(unpackb(b)) == b` for a flax file, and
the key order of the tree given decides the bytes.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
CHECKPOINT_DIR = Path(os.getenv("TILAWA_CHECKPOINT_DIR", str(_REPO_ROOT / "checkpoints")))
EXPORTS_DIR = Path(os.getenv("TILAWA_EXPORTS_DIR", str(_REPO_ROOT / "exports")))

_EXT_NDARRAY = 1
# Every leaf the shipped bundles hold (float32 weights, uint8 packed int4,
# int8 streaming weights). Anything else is a bundle this port cannot run.
_DTYPES = {"float32": np.float32, "uint8": np.uint8, "int8": np.int8}

_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


class MsgpackError(ValueError):
    pass


def _ndarray(data: memoryview) -> np.ndarray:
    (shape, dtype_name, buf), end = _decode(data, 0)
    if end != len(data):
        raise MsgpackError("trailing bytes in ndarray payload")
    if isinstance(dtype_name, memoryview):
        dtype_name = bytes(dtype_name).decode()
    dtype = _DTYPES.get(dtype_name)
    if dtype is None:
        raise MsgpackError(
            f"bundle leaf has dtype {dtype_name!r}; the port reads only {sorted(_DTYPES)}"
        )
    return np.frombuffer(buf, dtype=dtype).reshape(tuple(shape))


def _ext(code: int, data: memoryview):
    if code != _EXT_NDARRAY:
        raise MsgpackError(f"unsupported msgpack ext type {code}")
    return _ndarray(data)


def _decode(buf: memoryview, pos: int):
    """Decode one msgpack object at `pos`; returns (object, next position)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in (0xC4, 0xC5, 0xC6):              # bin 8/16/32
        fmt = (">B", ">H", ">I")[b - 0xC4]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        return buf[pos:pos + n], pos + n
    if b in (0xD9, 0xDA, 0xDB):              # str 8/16/32
        fmt = (">B", ">H", ">I")[b - 0xD9]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b in (0xDC, 0xDD):                    # array 16/32
        fmt = ">H" if b == 0xDC else ">I"
        n = struct.unpack_from(fmt, buf, pos)[0]
        return _array(buf, pos + struct.calcsize(fmt), n)
    if b in (0xDE, 0xDF):                    # map 16/32
        fmt = ">H" if b == 0xDE else ">I"
        n = struct.unpack_from(fmt, buf, pos)[0]
        return _map(buf, pos + struct.calcsize(fmt), n)
    if 0xD4 <= b <= 0xD8:                    # fixext 1/2/4/8/16
        n = 1 << (b - 0xD4)
        code = struct.unpack_from(">b", buf, pos)[0]
        pos += 1
        return _ext(code, buf[pos:pos + n]), pos + n
    if b in (0xC7, 0xC8, 0xC9):              # ext 8/16/32
        fmt = (">B", ">H", ">I")[b - 0xC7]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        code = struct.unpack_from(">b", buf, pos)[0]
        pos += 1
        return _ext(code, buf[pos:pos + n]), pos + n
    raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at {pos - 1}")


def _array(buf: memoryview, pos: int, n: int):
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        out.append(item)
    return out, pos


def _map(buf: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        out[key], pos = _decode(buf, pos)
    return out, pos


def unpackb(data: bytes | bytearray | memoryview):
    """Decode one msgpack document (flax.serialization.msgpack_restore's
    format) into nested dicts of numpy arrays."""
    buf = memoryview(data).cast("B")
    obj, end = _decode(buf, 0)
    if end != len(buf):
        raise MsgpackError(f"{len(buf) - end} trailing bytes after the document")
    return obj


# (type byte, length format, largest length) of each length-prefixed form
_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _header(n: int, forms: tuple, fix: int | None = None, fix_max: int = -1) -> bytes:
    """The smallest length header: the fix form when n fits it, else the
    first of `forms` whose length field holds n."""
    if fix is not None and n <= fix_max:
        return struct.pack(">B", fix | n)
    for code, fmt, limit in forms:
        if n <= limit:
            return struct.pack(">B", code) + struct.pack(fmt, n)
    raise MsgpackError(f"length {n} too large for msgpack")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v > 0 else \
        ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            out.append(struct.pack(">B", code) + struct.pack(fmt, v))
            return
        except struct.error:
            continue
    raise MsgpackError(f"int {v} does not fit 64 bits")


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += [_header(len(data), _STR, 0xA0, 31), data]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out += [_header(len(data), _BIN), data]
    elif isinstance(obj, dict):
        out.append(_header(len(obj), _MAP, 0x80, 15))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), _ARRAY, 0x90, 15))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.name not in _DTYPES:
            raise MsgpackError(f"cannot write dtype {obj.dtype.name}; the port writes "
                               f"{sorted(_DTYPES)}")
        payload = packb((obj.shape, obj.dtype.name, np.ascontiguousarray(obj).tobytes()))
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(struct.pack(">Bb", 0xD4 + n.bit_length() - 1, _EXT_NDARRAY))
        else:
            out.append(_header(n, _EXT) + struct.pack(">b", _EXT_NDARRAY))
        out.append(payload)
    else:
        raise MsgpackError(f"cannot write {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode nested dicts / lists of str, bytes, ints, floats and numpy
    arrays (float32, uint8, int8) as flax.serialization.msgpack_serialize
    does."""
    out: list[bytes] = []
    _pack(out, obj)
    return b"".join(out)


def read_variables(path: str | Path) -> dict:
    """`variables.msgpack` of a bundle directory → {"params": ..., "batch_stats": ...}."""
    return unpackb(Path(path, "variables.msgpack").read_bytes())


def load_variables(path: str | Path):
    """(FastConformerConfig, numpy variable tree) of a bundle directory."""
    from tilawa_tpu_torch.models.fastconformer import FastConformerConfig

    path = Path(path)
    return FastConformerConfig.from_json(path / "config.json"), read_variables(path)


def latest_checkpoint(root: str | Path | None = None) -> Path | None:
    """Newest training checkpoint under `root`; falls back to the newest
    shipped export bundle when no training checkpoints exist."""
    root = Path(root) if root else CHECKPOINT_DIR
    candidates = (
        [p.parent for p in root.rglob("variables.msgpack")]
        if root.exists() else []
    )
    if candidates:
        return max(candidates, key=lambda p: p.stat().st_mtime)
    if root == CHECKPOINT_DIR and EXPORTS_DIR.exists():
        bundles = [p.parent for p in EXPORTS_DIR.rglob("variables.msgpack")]
        if bundles:
            return max(bundles, key=lambda p: p.stat().st_mtime)
    return None


def shipped_checkpoint() -> Path | None:
    """Weights for serving/eval: `TILAWA_CHECKPOINT` env override, else the
    champion export bundle, else the newest shipped bundle, else the newest
    training checkpoint (serving never picks up in-flight training
    checkpoints implicitly)."""
    env = os.getenv("TILAWA_CHECKPOINT")
    if env:
        return Path(env)
    if EXPORTS_DIR.exists():
        champion = EXPORTS_DIR / "champion-int4"
        if (champion / "variables.msgpack").exists():
            return champion
        bundles = [p.parent for p in EXPORTS_DIR.rglob("variables.msgpack")]
        if bundles:
            return max(bundles, key=lambda p: p.stat().st_mtime)
    return latest_checkpoint()
