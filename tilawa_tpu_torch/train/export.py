"""Export contract writer: checkpoint → deployable bundle + metadata.

Port of tilawa_tpu/train/export.py: quantize (optionally) and write a
checkpoint with the port's msgpack writer, then `export_metadata.json`
with the model notes, vocab/blank ids, rerank parameters, the config and a
sha256 per file — the contract the port's server checks before it loads a
bundle (streaming/server.py ModelLoader). The metadata is the JAX
package's, key for key. A dequantized int4 bundle exported back to int4
is the same file, byte for byte (train/quantize.py).

Usage:
  python -m tilawa_tpu_torch.train.export --checkpoint checkpoints/<run> --int4
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from tilawa_tpu_torch.data.assets import ASSETS_DIR, EXPECTED_SHA256, sha256_file


def export_bundle(
    checkpoint: str | Path,
    out_dir: str | Path,
    int4: bool = True,
    quant: str | None = None,
) -> Path:
    """quant: explicit mode ("int4" | "int8" | "mixed" | None); falls back
    to the int4 flag when omitted."""
    from tilawa_tpu_torch.train.checkpoint import load_variables, save_variables
    from tilawa_tpu_torch.train.quantize import (
        dequantize_variables,
        dequantized_config,
        packed_size_bytes,
        quantize_variables,
        quantized_config,
    )

    mode = quant if quant is not None else ("int4" if int4 else None)
    config, variables = load_variables(checkpoint)
    if mode and config.quant != mode:
        if config.quant:
            if config.quant in ("int4", "mixed"):
                print(f"warning: re-quantizing a {config.quant} export; "
                      "int4 source precision is already reduced")
            variables = dequantize_variables(variables)
            config = dequantized_config(config)
        variables = quantize_variables(variables, mode=mode)
        config = quantized_config(config, mode=mode)

    out = Path(out_dir)
    save_variables(out, config, variables)

    files = {}
    for name in ("config.json", "variables.msgpack"):
        p = out / name
        files[name] = {"bytes": p.stat().st_size, "sha256": sha256_file(p)}
    # shared data assets ride along in the contract
    for name in ("tokenizer.model", "vocab.json"):
        p = ASSETS_DIR / name
        if p.exists():
            files[name] = {
                "bytes": p.stat().st_size,
                "sha256": sha256_file(p),
                "expected_sha256": EXPECTED_SHA256.get(name),
            }

    metadata = {
        "framework": "tilawa-tpu",
        "exported_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "model_notes": {
            "input": "audio_signal [B, N] float32 16 kHz + length int32 "
                     "(in-graph mel frontend)",
            "output": f"log_probs [B, T, {config.num_classes}] float32",
            "quant": config.quant or "none",
        },
        "vocab_tokens": config.num_classes,
        "blank_id": config.blank_id,
        "rerank": {"span_penalty": 0.5, "min_frames": "2L+1 <= T"},
        "config": config.to_dict(),
        "param_bytes": packed_size_bytes(variables["params"]),
        "files": files,
    }
    (out / "export_metadata.json").write_text(json.dumps(metadata, indent=2), encoding="utf-8")
    return out


def verify_bundle(bundle_dir: str | Path) -> dict[str, bool]:
    """Re-hash every file named in the manifest."""
    bundle = Path(bundle_dir)
    meta = json.loads((bundle / "export_metadata.json").read_text())
    out = {}
    for name, info in meta["files"].items():
        p = bundle / name if (bundle / name).exists() else ASSETS_DIR / name
        out[name] = p.exists() and sha256_file(p) == info["sha256"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="export a deployable bundle (PyTorch)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--int4", action="store_true", default=True)
    parser.add_argument("--fp", dest="int4", action="store_false")
    parser.add_argument("--quant", default=None, choices=["int4", "int8", "mixed"],
                        help="explicit quantization mode (overrides --int4/--fp)")
    parser.add_argument("--verify", action="store_true",
                        help="verify an existing bundle instead of exporting")
    args = parser.parse_args(argv)
    if args.verify:
        results = verify_bundle(args.checkpoint)
        print(json.dumps(results, indent=2))
        return 0 if all(results.values()) else 1
    out = args.out or (str(args.checkpoint).rstrip("/") + "_export")
    bundle = export_bundle(args.checkpoint, out, int4=args.int4, quant=args.quant)
    print(f"exported to {bundle}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
