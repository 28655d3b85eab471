"""Corpus-fit report: per-clip CTC loss of a checkpoint over the training
corpora, worst-first.

Port of tilawa_tpu/train/fit_report.py. Clips are grouped into the
training buckets (train/data.BUCKETS) and run in padded batches through
the model under torch.inference_mode(); the loss per clip is
train/train.ctc_losses (optax's value, infeasible rows included).

Usage (on the card unless --device cpu):
  python -m tilawa_tpu_torch.train.fit_report [--checkpoint DIR] [--corpora all]
        [--worst 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def corpus_fit(
    checkpoint: str | None = None,
    corpora: tuple[str, ...] = ("v1", "v2", "v3"),
    max_audio_s: float | None = None,
    device: str = "cuda",
) -> list[dict]:
    """[{id, corpus, seconds, tokens, loss}] for every decodable clip."""
    import torch

    from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
    from tilawa_tpu_torch.data.token_store import TokenStore
    from tilawa_tpu_torch.device import resolve_device, upload
    from tilawa_tpu_torch.eval.runner import load_manifest
    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.models.fastconformer import FastConformerCTC
    from tilawa_tpu_torch.train.checkpoint import latest_checkpoint, load_variables
    from tilawa_tpu_torch.train.data import BUCKETS
    from tilawa_tpu_torch.train.train import ctc_losses

    ckpt = checkpoint or latest_checkpoint()
    if ckpt is None:
        raise RuntimeError("no checkpoint found")
    dev = resolve_device(device)
    config, variables = load_variables(ckpt)
    model = load_into(FastConformerCTC(config), variables).to(dev).eval()
    store = TokenStore.load_default()
    cap = max_audio_s or BUCKETS[-1][0]

    examples = []
    for corpus in corpora:
        samples, corpus_dir = load_manifest(corpus)
        for s in samples:
            path = corpus_dir / s["file"]
            if not path.exists():
                continue
            try:
                audio = load_audio(path)
            except UnsupportedAudioFormat:
                continue
            if len(audio) > cap * 16000:
                continue
            ids: list[int] = []
            for e in s.get("expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]):
                ids.extend(store.ids_for_key(e["surah"], e["ayah"]) or [])
            if ids:
                examples.append((s["id"], corpus, audio, ids))

    out: list[dict] = []
    by_bucket: dict[float, list] = {}
    for ex in examples:
        sec = len(ex[2]) / 16000.0
        for bsec, _bs in BUCKETS:
            if sec <= bsec:
                by_bucket.setdefault(bsec, []).append(ex)
                break
    for bsec, exs in sorted(by_bucket.items()):
        bs = max(1, min(8, int(64 // max(bsec / 8, 1))))
        pad = int(bsec * 16000)
        tok_pad = int(np.ceil(max(len(e[3]) for e in exs) / 16) * 16)
        for i in range(0, len(exs), bs):
            chunk = exs[i : i + bs]
            audio = np.zeros((bs, pad), np.float32)
            alens = np.zeros(bs, np.int32)
            toks = np.zeros((bs, tok_pad), np.int32)
            tlens = np.ones(bs, np.int32)
            for j, (_sid, _c, a, ids) in enumerate(chunk):
                audio[j, : len(a)] = a
                alens[j] = len(a)
                toks[j, : len(ids)] = ids
                tlens[j] = len(ids)
            with torch.inference_mode():
                log_probs, enc_lens = model(upload(audio, dev), upload(alens, dev))
                losses = ctc_losses(log_probs, enc_lens, toks, tlens,
                                    config.blank_id).cpu().numpy()
            for j, (sid, corpus, a, ids) in enumerate(chunk):
                out.append({
                    "id": sid, "corpus": corpus, "seconds": round(len(a) / 16000.0, 1),
                    "tokens": len(ids), "loss": round(float(losses[j]), 3),
                })
    out.sort(key=lambda r: -r["loss"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="per-clip corpus-fit report (PyTorch)")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--corpora", default="all")
    parser.add_argument("--worst", type=int, default=20)
    parser.add_argument("--json", dest="json_out", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    corpora = ("v1", "v2", "v3") if args.corpora == "all" else tuple(args.corpora.split(","))
    rows = corpus_fit(args.checkpoint, corpora, device=args.device)
    losses = [r["loss"] for r in rows]
    print(f"{len(rows)} clips  mean loss {np.mean(losses):.3f}  "
          f"p90 {np.percentile(losses, 90):.3f}  max {max(losses):.3f}")
    for r in rows[: args.worst]:
        print(f"  {r['loss']:9.3f}  {r['id']:28s} {r['corpus']}  "
              f"{r['seconds']:6.1f}s  {r['tokens']} tok")
    if args.json_out:
        from pathlib import Path

        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
