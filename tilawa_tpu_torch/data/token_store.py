"""Precomputed CTC token sequences for verses and spans.

Reproduces the reference's quran_ctc_tokens.json contract (12.2 MB asset,
keys "surah:ayah:ayah_end" — reference: web/frontend/public/export_metadata.json,
web/frontend/src/worker/quran-text-adapter.ts:16-18; LFS-missing in the
snapshot, regenerated here from tokenizer + quran.json as SURVEY.md Phase 0
prescribes), and additionally materializes the device-side form the TPU
rerank wants: a padded [N, L_max] int32 matrix + lengths, saved as .npz.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.assets import ASSETS_DIR
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.data.tokenizer import SentencePieceBPE

DEFAULT_MAX_SPAN = 6


def span_keys(db: QuranDB, max_span: int = DEFAULT_MAX_SPAN):
    """Yield (surah, ayah, ayah_end, text) for every verse and every
    2..max_span consecutive-ayah span (bismillah-stripped first verse)."""
    for surah in sorted(db._by_surah):
        verses = db.get_surah(surah)
        n = len(verses)
        for i, v in enumerate(verses):
            text = v["text_clean_no_bsm"] or v["text_clean"]
            yield surah, v["ayah"], v["ayah"], text
            for span in range(2, max_span + 1):
                if i + span > n:
                    break
                chunk = verses[i : i + span]
                first = chunk[0]["text_clean_no_bsm"] or chunk[0]["text_clean"]
                combined = " ".join([first] + [c["text_clean"] for c in chunk[1:]])
                yield surah, v["ayah"], chunk[-1]["ayah"], combined


def build_ctc_tokens(
    db: QuranDB | None = None,
    tokenizer: SentencePieceBPE | None = None,
    max_span: int = DEFAULT_MAX_SPAN,
) -> dict[str, list[int]]:
    db = db or QuranDB()
    tokenizer = tokenizer or SentencePieceBPE.load_default()
    out: dict[str, list[int]] = {}
    for surah, ayah, ayah_end, text in span_keys(db, max_span):
        out[f"{surah}:{ayah}:{ayah_end}"] = tokenizer.encode(text)
    return out


class TokenStore:
    """Verse/span token-id lookup with lazy caching.

    The champion pipeline tokenizes candidate texts on demand with a cache
    (reference: c2c-direct/run.py:215-221); loading the materialized JSON
    short-circuits that entirely.
    """

    def __init__(
        self,
        tokenizer: SentencePieceBPE | None = None,
        precomputed: dict[str, list[int]] | None = None,
    ):
        self.tokenizer = tokenizer or SentencePieceBPE.load_default()
        self._by_key: dict[str, list[int]] = dict(precomputed or {})
        self._by_text: dict[str, list[int]] = {}

    @classmethod
    def load_default(cls) -> "TokenStore":
        tok = SentencePieceBPE.load_default()
        path = ASSETS_DIR / "quran_ctc_tokens.json"
        pre = None
        if path.exists():
            with open(path, encoding="utf-8") as f:
                pre = json.load(f)
        return cls(tok, pre)

    def ids_for_key(self, surah: int, ayah: int, ayah_end: int | None = None) -> list[int] | None:
        return self._by_key.get(f"{surah}:{ayah}:{ayah_end or ayah}")

    def ids_for_text(self, text: str) -> list[int]:
        hit = self._by_text.get(text)
        if hit is None:
            hit = self.tokenizer.encode(text)
            self._by_text[text] = hit
        return hit

    def validate_round_trip(self, db, sample_every: int = 500) -> list[str]:
        """Decode a sample of precomputed verse token ids back to text and
        compare against the stored verse text (asset-integrity check;
        reference: worker/quran-text-adapter.ts:54-75 round-trip sampling).
        Returns a list of mismatch descriptions (empty == healthy)."""
        from tilawa_tpu_torch.data.normalizer import normalize_arabic

        problems: list[str] = []
        keys = sorted(self._by_key)
        for key in keys[::max(sample_every, 1)]:
            surah, ayah, ayah_end = (int(x) for x in key.split(":"))
            if ayah_end != ayah:
                continue  # span texts are derived; verse rows are the source
            verse = db.get_verse(surah, ayah)
            if not verse:
                continue
            decoded = normalize_arabic(
                self.tokenizer.decode(self._by_key[key]).strip()
            )
            expected = normalize_arabic(verse["text_clean"])
            if decoded == expected:
                continue
            # Characters outside the BPE vocab decode to the unk marker —
            # expected for a handful of rare codepoints; anything beyond a
            # near-perfect match after dropping unks is a real corruption.
            from tilawa_tpu_torch.text.levenshtein import ratio

            cleaned = " ".join(decoded.replace("⁇", " ").split())
            if ratio(cleaned, expected) < 0.97:
                problems.append(f"{key}: {decoded!r} != {expected!r}")
        return problems

    def ids_for_candidate(self, cand: dict) -> list[int]:
        """Token ids for a candidate dict ({surah, ayah, ayah_end?, ctc_text/
        text_clean}) — precomputed key first, tokenize-on-demand fallback."""
        ids = self.ids_for_key(cand["surah"], cand["ayah"], cand.get("ayah_end"))
        if ids is not None:
            return ids
        text = cand.get("ctc_text") or cand.get("text_clean") or ""
        return self.ids_for_text(text) if text else []


def write_assets(
    out_dir: str | Path | None = None, max_span: int = DEFAULT_MAX_SPAN
) -> tuple[Path, Path]:
    """Materialize quran_ctc_tokens.json (reference contract) and the padded
    device matrix quran_ctc_tokens.npz (verse-only rows, for full-DB rerank)."""
    out_dir = Path(out_dir) if out_dir else ASSETS_DIR
    db = QuranDB()
    tok = SentencePieceBPE.load_default()
    mapping = build_ctc_tokens(db, tok, max_span)

    json_path = out_dir / "quran_ctc_tokens.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(mapping, f, ensure_ascii=False, separators=(",", ":"))

    verse_ids = []
    refs = []
    for v in db.verses:
        ids = mapping[f"{v['surah']}:{v['ayah']}:{v['ayah']}"]
        verse_ids.append(ids)
        refs.append((v["surah"], v["ayah"]))
    lmax = max(len(x) for x in verse_ids)
    matrix = np.zeros((len(verse_ids), lmax), dtype=np.int32)
    lengths = np.zeros(len(verse_ids), dtype=np.int32)
    for i, ids in enumerate(verse_ids):
        matrix[i, : len(ids)] = ids
        lengths[i] = len(ids)
    npz_path = out_dir / "quran_ctc_tokens.npz"
    np.savez_compressed(
        npz_path,
        tokens=matrix,
        lengths=lengths,
        refs=np.array(refs, dtype=np.int32),
    )
    return json_path, npz_path


if __name__ == "__main__":
    jp, np_ = write_assets()
    print(f"wrote {jp} and {np_}")
