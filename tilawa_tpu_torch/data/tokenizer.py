"""Pure-Python SentencePiece tokenizer (model-proto parser + unigram Viterbi).

The reference reaches SentencePiece through NeMo's C++ binding
(reference: experiments/c2c-direct/run.py:204,219 — tokenizer.text_to_ids /
ids_to_text over web/frontend/public/tokenizer.model). This module re-implements
the needed subset natively in Python:

  * a minimal protobuf wire-format reader for ModelProto
    (field 1: repeated SentencePiece {piece, score, type},
     field 2: TrainerSpec, field 3: NormalizerSpec)
  * despite the export metadata labelling it "BPE", the shipped
    tokenizer.model is a **unigram** model (TrainerSpec.model_type == 1),
    so encoding is Viterbi max-sum segmentation over piece log-probs —
    exactly SentencePiece's EncodeAsIds for unigram models
  * decode: ids -> pieces -> '▁'->' ' join

Normalization approximates the model's `nmt_nfkc` spec with
unicodedata.NFKC + NMT control-character cleanup; for the Quranic-Arabic
domain the two agree (validated by round-trip over all 6,236 verses in
tests/test_tokenizer.py).

Token ids 0..1023 align with assets/vocab.json; the CTC blank (1024) is a
model-head concept, not a tokenizer symbol.
"""

from __future__ import annotations

import struct
import unicodedata
from pathlib import Path

from tilawa_tpu_torch.data.assets import default_asset_path

_UNK_PENALTY = 10.0


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    res = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        res |= (b & 0x7F) << shift
        if not b & 0x80:
            return res, i
        shift += 7


def _iter_fields(buf: bytes, start: int = 0, end: int | None = None):
    """Yield (field_number, wire_type, value) triples from a protobuf blob."""
    i = start
    end = len(buf) if end is None else end
    while i < end:
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i : i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i : i + ln], i + ln
        elif wt == 5:
            v, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt} at offset {i}")
        yield field, wt, v


class SentencePieceBPE:
    """SentencePiece tokenizer over tokenizer.model (unigram segmentation).

    Name kept as the framework-facing alias — the reference export calls
    this artifact its "SentencePiece BPE" tokenizer even though the proto
    says unigram; encode/decode semantics match SentencePiece.
    """

    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, pieces: list[tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_to_id: dict[str, int] = {}
        self.scores: list[float] = []
        self.unk_id = 0
        self.max_piece_len = 1
        for idx, (piece, score, ptype) in enumerate(pieces):
            self.piece_to_id.setdefault(piece, idx)
            self.scores.append(score)
            if ptype == self.UNKNOWN:
                self.unk_id = idx
            if ptype in (self.NORMAL, self.USER_DEFINED):
                self.max_piece_len = max(self.max_piece_len, len(piece))
        real_scores = [
            s for (_, s, t) in pieces if t in (self.NORMAL, self.USER_DEFINED)
        ]
        self._min_score = min(real_scores) if real_scores else 0.0
        self._unk_score = self._min_score - _UNK_PENALTY

    # ------------------------------------------------------------- loading

    @classmethod
    def from_model_file(cls, path: str | Path) -> "SentencePieceBPE":
        data = Path(path).read_bytes()
        pieces: list[tuple[str, float, int]] = []
        for field, _wt, value in _iter_fields(data):
            if field != 1:
                continue
            piece, score, ptype = "", 0.0, cls.NORMAL
            for sf, _swt, sv in _iter_fields(value):
                if sf == 1:
                    piece = sv.decode("utf-8")
                elif sf == 2:
                    score = struct.unpack("<f", sv)[0]
                elif sf == 3:
                    ptype = sv
            pieces.append((piece, score, ptype))
        return cls(pieces)

    @classmethod
    def load_default(cls) -> "SentencePieceBPE":
        return cls.from_model_file(default_asset_path("tokenizer.model"))

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # -------------------------------------------------------- normalization

    @staticmethod
    def _normalize(text: str) -> str:
        """Approximate SentencePiece nmt_nfkc: NFKC + NMT cleanup +
        whitespace collapse."""
        out = []
        for ch in unicodedata.normalize("NFKC", text):
            cp = ord(ch)
            if cp in (0xFEFF, 0x200B, 0x200C, 0x200D, 0x200E, 0x200F, 0x0000):
                continue
            if cp < 0x20 and ch not in "\t\n\r":
                continue
            out.append(" " if ch in "\t\n\r" else ch)
        s = "".join(out)
        while "  " in s:
            s = s.replace("  ", " ")
        return s.strip()

    # -------------------------------------------------------------- encode

    def encode(self, text: str) -> list[int]:
        """text -> token ids via unigram Viterbi segmentation."""
        s = self._normalize(text)
        if not s:
            return []
        s = "▁" + s.replace(" ", "▁")  # dummy prefix + escape spaces

        n = len(s)
        neg_inf = float("-inf")
        best = [neg_inf] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        piece_to_id = self.piece_to_id
        scores = self.scores
        max_len = self.max_piece_len
        for i in range(n):
            bi = best[i]
            if bi == neg_inf:
                continue
            matched = False
            hi = min(n, i + max_len)
            for j in range(i + 1, hi + 1):
                pid = piece_to_id.get(s[i:j])
                if pid is None:
                    continue
                matched = True
                cand = bi + scores[pid]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, pid)
            if not matched or back[i + 1] is None:
                # unk fallback: consume one char
                cand = bi + self._unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, self.unk_id)

        ids: list[int] = []
        j = n
        while j > 0:
            i, pid = back[j]  # type: ignore[misc]
            ids.append(pid)
            j = i
        ids.reverse()
        return ids

    def encode_pieces(self, text: str) -> list[str]:
        return [self.pieces[i][0] for i in self.encode(text)]

    # -------------------------------------------------------------- decode

    def decode(self, ids: list[int]) -> str:
        parts = []
        for i in ids:
            if 0 <= i < len(self.pieces):
                piece, _s, ptype = self.pieces[i]
                if ptype in (self.CONTROL, self.UNUSED):
                    continue
                parts.append(" ⁇ " if ptype == self.UNKNOWN else piece)
        return "".join(parts).replace("▁", " ").strip()

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]
