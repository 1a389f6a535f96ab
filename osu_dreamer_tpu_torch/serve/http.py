"""Stdlib HTTP front-end for the generation service.

Counterpart of osu_dreamer_tpu/serve/http.py: the same endpoints, parameters
and status codes. Endpoints (JSON errors, octet-stream results):

- ``GET /healthz``   — liveness + device info
- ``GET /stats``     — request/batch counters and queue depth
- ``POST /generate`` — body: raw audio bytes. Query params:
    ``diff``         repeatable "sr,ar,od,cs,hp" row (default 5,9,8,4,6)
    ``sample_steps`` int, default 8
    ``style_guidance`` float, default 1.0
    ``seed``         int; seeded requests are never co-batched
    ``infer_tempo``  0/1 — infer BPM/offset from the predicted onsets
    ``snap_divisor`` int — snap hit times to 1/N of the inferred beat
                     (implies tempo inference); both default to the
                     service's CLI-configured values
    ``title`` / ``artist``  metadata strings
    ``name``         audio filename (drives the container demuxer and the
                     name stored inside the .osz), default "audio.wav"
  Response: the ``.osz`` bytes with a Content-Disposition filename.

Threading model: ``ThreadingHTTPServer`` gives each request its own thread;
all device work funnels through the service's single dispatcher thread,
which batches concurrent requests (serve/service.py).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .service import GeneratorService

MAX_AUDIO_BYTES = 256 * 1024 * 1024


def _header_safe(value: str) -> str:
    """strip CR/LF/quotes/control chars so a user-supplied name cannot
    inject response headers or break the Content-Disposition quoting"""
    return "".join(
        c for c in value if c.isprintable() and c not in '"\\'
    ).strip() or "mapset.osz"


def _make_handler(service: GeneratorService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, service.health())
            elif path == "/stats":
                self._json(200, service.snapshot_stats())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/generate":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            q = parse_qs(url.query)

            body_read = False
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= MAX_AUDIO_BYTES:
                    raise ValueError(
                        f"Content-Length must be in (0, {MAX_AUDIO_BYTES}]"
                    )
                audio = self.rfile.read(length)
                body_read = True

                diffs = None
                if "diff" in q:
                    diffs = [
                        [float(v) for v in row.split(",")] for row in q["diff"]
                    ]
                    if any(len(r) != 5 for r in diffs):
                        raise ValueError("each diff must be sr,ar,od,cs,hp")

                def one(key: str, default: Optional[str] = None) -> Optional[str]:
                    return q[key][0] if key in q else default

                name, osz = service.generate(
                    audio,
                    audio_name=one("name", "audio.wav"),
                    diffs=diffs,
                    sample_steps=int(one("sample_steps", "8")),
                    style_guidance=float(one("style_guidance", "1.0")),
                    seed=int(one("seed")) if "seed" in q else None,
                    title=one("title"),
                    artist=one("artist"),
                    infer_tempo=(
                        one("infer_tempo").lower() in ("1", "true", "yes")
                        if "infer_tempo" in q else None
                    ),
                    snap_divisor=(
                        int(one("snap_divisor"))
                        if "snap_divisor" in q else None
                    ),
                )
            except Exception as e:
                # an unread body would desync this keep-alive connection:
                # the next "request line" would be audio bytes
                if not body_read:
                    self.close_connection = True
                # 400 = the request was bad (params, undecodable audio);
                # 503 = the service couldn't serve it in time; 500 = it
                # broke serving it. Never let an exception escape: that
                # kills the handler thread mid-response.
                if isinstance(e, TimeoutError):
                    self._json(503, {"error": str(e)})
                elif isinstance(e, RuntimeError):
                    self._json(500, {"error": str(e)})
                elif isinstance(e, ValueError):
                    self._json(400, {"error": str(e)})
                else:  # audio decode / codec errors: the client's bytes
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return

            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header(
                "Content-Disposition",
                f'attachment; filename="{_header_safe(name)}"',
            )
            self.send_header("Content-Length", str(len(osz)))
            self.end_headers()
            self.wfile.write(osz)

    return Handler


class MapServer:
    """owns the HTTP server + service pair; ``with MapServer(...) as s:`` in
    tests, ``serve_forever()`` from the CLI"""

    def __init__(self, service: GeneratorService, host: str = "127.0.0.1", port: int = 8787):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(service))
        self.httpd.daemon_threads = True

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()

    def __enter__(self):
        self.start_background()
        return self

    def __exit__(self, *exc):
        self.close()
