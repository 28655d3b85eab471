"""Console entry point: `python -m tilawa_tpu_torch.cli <audio...>` prints
one JSON line per file with the recognized (surah, ayah, ayah_end).

Port of tilawa_tpu/cli.py recognize_main on the torch runtime; runs on the
card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys


def recognize_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Recognize Quran verses in audio files (surah:ayah out)"
    )
    parser.add_argument("audio", nargs="+", help="16 kHz-ish wav files")
    parser.add_argument("--no-tta", action="store_true")
    parser.add_argument("--transcript", action="store_true",
                        help="also print the raw transcript")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain ops)")
    args = parser.parse_args(argv)

    from tilawa_tpu_torch.eval.experiments import load_champion
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    recognizer = Recognizer(load_champion(args.device), tta=not args.no_tta)
    status = 0
    for path in args.audio:
        try:
            result = recognizer.predict(path)
        except Exception as e:  # noqa: BLE001 — one bad file must not stop the rest
            print(f"{path}: ERROR {e}", file=sys.stderr)
            status = 1
            continue
        out = {
            "file": path,
            "surah": result["surah"],
            "ayah": result["ayah"],
            "ayah_end": result["ayah_end"],
            "score": result["score"],
        }
        if args.transcript:
            out["transcript"] = result.get("transcript", "")
        print(json.dumps(out, ensure_ascii=False))
    return status


if __name__ == "__main__":
    sys.exit(recognize_main())
