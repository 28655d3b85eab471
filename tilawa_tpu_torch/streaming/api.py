"""REST surface beside the WS endpoint: status, surah lookup, user error
reports, diagnostics uploads, and an admin summary.

Parity targets:
  GET  /api/status         — backend + db info (reference: web/server.py:1050-1059)
  GET  /api/surah/{n}      — verse list for the mushaf display (server.py:1038-1048)
  POST /api/reports        — user error report (JSON metadata + base64 audio)
                             persisted to a reports dir (reference:
                             web/frontend/server/reports.ts:11-46)
  POST /api/diagnostics    — auto-captured tracker diagnostic bundles
                             (server/diagnostics.ts:13-50)
  GET  /admin              — JSON dashboard summary (server/admin.ts)
  GET  /                   — the browser app shell (web/index.html; reference:
                             web/frontend/index.html + src/main.ts)
"""

from __future__ import annotations

import base64
import json
import time
from pathlib import Path

from tilawa_tpu_torch.data.quran import QuranDB

_WEB_DIR = Path(__file__).resolve().parent.parent.parent / "web"
_STATIC_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".js": "text/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".webmanifest": "application/manifest+json",
}


class ApiService:
    def __init__(
        self,
        db: QuranDB | None = None,
        storage_dir: str | Path = "storage",
        backend: str = "unknown",
        model_state=None,
    ):
        self.db = db or QuranDB()
        self.storage = Path(storage_dir)
        self.backend = backend
        self.model_state = model_state  # callable -> load-progress dict
        self.started = time.time()
        self.reports_dir = self.storage / "reports"
        self.diagnostics_dir = self.storage / "diagnostics"

    # --------------------------------------------------------------- routes

    async def handle(self, method: str, path: str, headers: dict, body: bytes):
        """(status, content_type, payload) — the ws.serve http_handler."""
        route = path.split("?")[0].rstrip("/") or "/"
        if method == "GET" and route == "/api/status":
            return self._json(200, self.status())
        if method == "GET" and route.startswith("/api/surah/"):
            return self._surah(route.rsplit("/", 1)[-1])
        if method == "POST" and route == "/api/reports":
            return self._json(201, self.save_report(self._parse(body)))
        if method == "POST" and route == "/api/diagnostics":
            return self._json(201, self.save_diagnostics(self._parse(body)))
        if method == "GET" and route == "/admin":
            return self._json(200, self.admin_summary())
        if method == "GET":
            static = self._static(route)
            if static is not None:
                return static
        return 404, "application/json", b'{"error": "not found"}'

    @staticmethod
    def _static(route: str):
        """Serve the browser app shell from web/ (no path traversal)."""
        name = "index.html" if route == "/" else route.lstrip("/")
        if "/" in name or name.startswith("."):
            return None
        path = _WEB_DIR / name
        ctype = _STATIC_TYPES.get(path.suffix)
        if ctype is None or not path.is_file():
            return None
        return 200, ctype, path.read_bytes()

    # ------------------------------------------------------------- handlers

    def status(self) -> dict:
        out = {
            "status": "ok",
            "backend": self.backend,
            "verses": self.db.total_verses,
            "uptime_s": round(time.time() - self.started, 1),
        }
        if self.model_state is not None:
            # model load/verify/warmup progress (the server-side analogue
            # of the reference's model-cache download progress,
            # model-cache.ts:38-70) — the shell polls this until ready.
            out["model"] = self.model_state()
        return out

    def _surah(self, raw: str):
        try:
            n = int(raw)
        except ValueError:
            return 400, "application/json", b'{"error": "bad surah"}'
        verses = self.db.get_surah(n)
        if not verses:
            return 404, "application/json", b'{"error": "unknown surah"}'
        return self._json(
            200,
            {
                "surah": n,
                "verses": [
                    {"ayah": v["ayah"],
                     "text_uthmani": v.get("text_uthmani") or v["text_clean"]}
                    for v in verses
                ],
            },
        )

    def save_report(self, payload: dict) -> dict:
        """User error report: JSON metadata (+ optional base64 wav) → one
        timestamped dir per report."""
        rid = f"report_{int(time.time() * 1000)}"
        d = self.reports_dir / rid
        d.mkdir(parents=True, exist_ok=True)
        audio_b64 = payload.pop("audio_base64", None)
        (d / "report.json").write_text(
            json.dumps(payload, ensure_ascii=False, indent=2), encoding="utf-8"
        )
        if audio_b64:
            (d / "audio.wav").write_bytes(base64.b64decode(audio_b64))
        return {"id": rid, "saved": True}

    def save_diagnostics(self, payload: dict) -> dict:
        rid = f"diag_{int(time.time() * 1000)}"
        self.diagnostics_dir.mkdir(parents=True, exist_ok=True)
        (self.diagnostics_dir / f"{rid}.json").write_text(
            json.dumps(payload, ensure_ascii=False), encoding="utf-8"
        )
        return {"id": rid, "saved": True}

    def admin_summary(self) -> dict:
        def _count(d: Path) -> int:
            return sum(1 for _ in d.iterdir()) if d.exists() else 0

        return {
            **self.status(),
            "reports": _count(self.reports_dir),
            "diagnostics": _count(self.diagnostics_dir),
        }

    # -------------------------------------------------------------- helpers

    @staticmethod
    def _parse(body: bytes) -> dict:
        try:
            out = json.loads(body.decode("utf-8")) if body else {}
            return out if isinstance(out, dict) else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return {}

    @staticmethod
    def _json(status: int, obj: dict):
        return status, "application/json", json.dumps(
            obj, ensure_ascii=False
        ).encode("utf-8")
