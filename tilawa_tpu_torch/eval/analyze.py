"""Failure-taxonomy analysis of benchmark result files.

Port of the reference's exact-match-oriented failure classifier
(reference: web/frontend/test/analyze-v3-stability.ts:11-117 — classes
exact / missing_only / extra_after_expected / extra_before_expected /
wrong_initial / wrong_surah_jump / no_emit / partial_multi), applied to
the per_sample entries a runner writes (the port's results_torch/*.json,
or the JAX package's benchmark/results/*.json: the same rows). A copy of
tilawa_tpu/eval/analyze.py.

Usage:
  python -m tilawa_tpu_torch.eval.analyze results_torch/<ts>.json
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

CLASSES = (
    "exact", "missing_only", "extra_after_expected", "extra_before_expected",
    "wrong_initial", "wrong_surah_jump", "no_emit", "partial_multi",
)


def _refs(entries: list[dict]) -> list[str]:
    out = []
    for e in entries:
        if not e.get("surah"):
            continue
        end = e.get("ayah_end")
        out.append(f"{e['surah']}:{e['ayah']}")
        if end and end != e["ayah"]:
            out.extend(f"{e['surah']}:{a}" for a in range(e["ayah"] + 1, end + 1))
    return out


def _is_subsequence(needle: list[str], haystack: list[str]) -> bool:
    pos = 0
    for item in haystack:
        if pos < len(needle) and needle[pos] == item:
            pos += 1
    return pos == len(needle)


def _is_prefix(prefix: list[str], values: list[str]) -> bool:
    return len(prefix) <= len(values) and values[: len(prefix)] == prefix


def classify_run(expected: list[str], discovered: list[str]) -> str:
    """One emission sequence → failure class (reference taxonomy,
    analyze-v3-stability.ts:75-117)."""
    if not discovered:
        return "no_emit"
    if expected == discovered:
        return "exact"

    expected_set = set(expected)
    discovered_set = set(discovered)
    missing = [r for r in expected if r not in discovered_set]
    extras = [r for r in discovered if r not in expected_set]

    if len(expected) > 1 and missing:
        return "partial_multi"
    if not extras and missing:
        return "missing_only"
    if extras and discovered[0] not in expected_set:
        return "wrong_initial"
    if extras:
        expected_surahs = {r.split(":")[0] for r in expected}
        if _is_subsequence(expected, discovered):
            seen_all_at = next(
                (
                    i
                    for i in range(len(discovered))
                    if _is_subsequence(expected, discovered[: i + 1])
                ),
                len(discovered),
            )
            if any(
                r.split(":")[0] not in expected_surahs
                for r in discovered[seen_all_at:]
            ):
                return "wrong_surah_jump"
        if _is_prefix(expected, discovered) or _is_subsequence(expected, discovered):
            return "extra_after_expected"
        return "extra_before_expected"
    return "missing_only"


def analyze_results(results: dict | list) -> dict:
    """Runner results JSON (one experiment dict or a list of them) →
    {experiment, counts, failures: [{id, class, expected, discovered}]}."""
    if isinstance(results, list):
        results = results[0]
    counts: Counter[str] = Counter()
    failures = []
    for s in results.get("per_sample", []):
        expected = _refs(s.get("expected", []))
        discovered = _refs(s.get("predicted", []))
        klass = classify_run(expected, discovered)
        counts[klass] += 1
        if klass != "exact":
            failures.append(
                {
                    "id": s.get("id"),
                    "class": klass,
                    "expected": expected,
                    "discovered": discovered,
                }
            )
    return {
        "experiment": results.get("name"),
        "total": sum(counts.values()),
        "counts": dict(counts),
        "failures": failures,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="failure taxonomy analyzer")
    parser.add_argument("results", help="benchmark results JSON from the runner")
    parser.add_argument("--verbose", action="store_true",
                        help="print every failing sample")
    args = parser.parse_args(argv)
    data = json.loads(Path(args.results).read_text(encoding="utf-8"))
    report = analyze_results(data)
    print(f"taxonomy: {report['experiment']}  ({report['total']} samples)")
    for klass, n in sorted(
        report["counts"].items(), key=lambda kv: (-kv[1], kv[0])
    ):
        print(f"  {klass:24s} {n}")
    if args.verbose:
        for f in report["failures"]:
            print(f"  {f['id']}: {f['class']}  expected={f['expected']} "
                  f"got={f['discovered']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
