"""Asset registry with integrity verification.

The reference ships an asset contract in export_metadata.json (sha256 per
file; reference: web/frontend/public/export_metadata.json, verified at
worker init — web/frontend/src/worker/inference.ts:114-117). This module is
the framework-side equivalent: a registry of data assets, their expected
digests, and helpers to resolve + verify them.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
ASSETS_DIR = Path(os.getenv("TILAWA_ASSETS_DIR", str(_REPO_ROOT / "assets")))

# Digests match the reference export contract where the asset is shared
# (tokenizer.model / vocab.json sha256 from export_metadata.json).
EXPECTED_SHA256 = {
    "tokenizer.model": "1fcfa104fa448c979cc2537788947c6516827f403ecdc55c4895b77d28630ba4",
    "vocab.json": "c55877f3bff8bc3aaefc160e8c2fb88cb349088d092513d40210ccfe535e671b",
}

VOCAB_TOKENS = 1025
BLANK_ID = 1024


def default_asset_path(name: str) -> Path:
    p = ASSETS_DIR / name
    if not p.exists():
        raise FileNotFoundError(
            f"asset {name!r} not found under {ASSETS_DIR} "
            "(set TILAWA_ASSETS_DIR to relocate)"
        )
    return p


def sha256_file(path: str | Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_asset(name: str) -> bool:
    """True if the asset exists and (when a digest is registered) matches."""
    try:
        p = default_asset_path(name)
    except FileNotFoundError:
        return False
    expected = EXPECTED_SHA256.get(name)
    return expected is None or sha256_file(p) == expected


def verify_all(strict: bool = False) -> dict[str, bool]:
    out = {name: verify_asset(name) for name in EXPECTED_SHA256}
    if strict and not all(out.values()):
        bad = [k for k, ok in out.items() if not ok]
        raise RuntimeError(f"asset integrity check failed: {bad}")
    return out


def load_vocab(path: str | Path | None = None) -> list[str]:
    """The 1,025-token BPE vocabulary as an id-indexed list."""
    p = Path(path) if path else default_asset_path("vocab.json")
    with open(p, encoding="utf-8") as f:
        raw = json.load(f)
    vocab = [""] * len(raw)
    for k, v in raw.items():
        vocab[int(k)] = v
    return vocab
