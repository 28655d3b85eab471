"""Arabic / Quranic text normalization.

Behavioral parity with the reference normalizer (reference:
shared/normalizer.py:45-94 and web/frontend/src/lib/normalizer.ts), built
around cached single-pass ``str.translate`` tables instead of a regex chain:
the hot path (normalizing every streaming transcript and all 6,236 verses at
DB build) is one table lookup per character plus a handful of rare multi-char
rewrites.

Rules (grouped by flag, all default-on except ``strip_hamza``):

  diacritics      — drop tashkeel/harakat U+064B..U+065F; unify alef variants
                    (madda, wasla, U+0672/0673, khanjar alef) to bare alef;
                    Farsi yeh/kaf to Arabic yeh/kaf.
  markers /       — drop Quranic annotation + small-letter block U+06D6..U+06ED.
  small_letters
  verse_numbers   — drop ornate parens U+FD3E/FD3F and Arabic-Indic digits.
  tatweel         — drop U+0640.
  punctuation     — drop .,;:!?… and Arabic comma/semicolon/question mark.
  strip_hamza     — aggressive Uthmani↔common matching: drop ء أ إ ئ,
                    alef-maqsura→yeh, وة/واة→اة, يي→ي, بصط→بسط, صيطر→سيطر,
                    and collapse الل→ال.

BOM / RLM / LRM are always removed; whitespace is collapsed by default.
"""

from __future__ import annotations

import re
from functools import lru_cache

_ALEF = "ا"
_YEH = "ي"
_KAF = "ك"

# Always-removed invisibles.
_INVISIBLES = {0xFEFF: None, 0x200F: None, 0x200E: None}

# Multi-char rewrites that must run *before* the char table so the khanjar
# alef in the two-char sequence "اٰ" collapses to one alef, not two.
_PRE_KHANJAR = ("اٰ", _ALEF)

_PUNCT = ".,;:!?…،؛؟"

# strip_hamza multi-char rewrites, applied after the char table.
_RE_WAW_TA = re.compile("وا?ة")   # وة / واة -> اة
_RE_DOUBLE_YA = re.compile("يي")       # يي -> ي
_RE_BST = re.compile("بصط")       # بصط -> بسط
_RE_SYTR = re.compile("صيطر")  # صيطر -> سيطر
_RE_DEF_LAM = re.compile("الل")   # الل -> ال (post hamza-strip)
_RE_WS = re.compile(r"\s+")


@lru_cache(maxsize=64)
def _table(
    diacritics: bool,
    markers_or_small: bool,
    verse_numbers: bool,
    tatweel: bool,
    punctuation: bool,
    strip_hamza: bool,
) -> dict[int, str | None]:
    t: dict[int, str | None] = dict(_INVISIBLES)
    if diacritics:
        for cp in range(0x064B, 0x0660):           # tashkeel
            t[cp] = None
        for cp in (0x0622, 0x0671, 0x0672, 0x0673, 0x0670):
            t[cp] = _ALEF
        t[0x06CC] = _YEH                            # Farsi yeh
        t[0x06D2] = _YEH                            # yeh barree
        t[0x06A9] = _KAF                            # Farsi kaf
    if markers_or_small:
        for cp in range(0x06D6, 0x06EE):            # Quranic annotations
            t[cp] = None
    if verse_numbers:
        t[0xFD3E] = None
        t[0xFD3F] = None
        for cp in range(0x0660, 0x066A):            # Arabic-Indic digits
            t[cp] = None
        for cp in range(0x06F0, 0x06FA):            # Extended Arabic-Indic
            t[cp] = None
    if tatweel:
        t[0x0640] = None
    if punctuation:
        for ch in _PUNCT:
            t[ord(ch)] = None
    if strip_hamza:
        for cp in (0x0621, 0x0623, 0x0625, 0x0626):  # ء أ إ ئ
            t[cp] = None
        t[0x0649] = _YEH                             # alef maqsura -> yeh
    return t


def normalize_arabic(
    text: str,
    diacritics: bool = True,
    markers: bool = True,
    verse_numbers: bool = True,
    tatweel: bool = True,
    small_letters: bool = True,
    punctuation: bool = True,
    collapse_whitespace: bool = True,
    strip_hamza: bool = False,
) -> str:
    """Normalize Arabic/Quranic text; see module docstring for the rule set."""
    s = str(text)
    if diacritics and _PRE_KHANJAR[0] in s:
        s = s.replace(_PRE_KHANJAR[0], _PRE_KHANJAR[1])
    s = s.translate(
        _table(
            diacritics,
            markers or small_letters,
            verse_numbers,
            tatweel,
            punctuation,
            strip_hamza,
        )
    )
    if strip_hamza:
        s = _RE_WAW_TA.sub("اة", s)
        s = _RE_DOUBLE_YA.sub(_YEH, s)
        s = _RE_BST.sub("بسط", s)
        s = _RE_SYTR.sub("سيطر", s)
        s = _RE_DEF_LAM.sub("ال", s)
    if collapse_whitespace:
        s = _RE_WS.sub(" ", s).strip()
    return s
