"""HTTP serving adapter: a JSON API over the streaming front end.

Port of ``stac_st_tpu/serving_http.py``. Stdlib-only (``http.server``) so
it runs anywhere the framework does; for heavy deployments put a real
ingress in front — this adapter's job is to expose the engine's coalescing
queue on a socket:

    POST /v1/translate       {"audio": [f32...] | "audio_b64": base64-f32le,
                              "source_lang": "es", "target_lang": "en"}
    POST /v1/transcribe      {"audio": ..., "source_lang": "es"}
    POST /v1/transcribe_translate  {"audio": ..., "source_lang": "es",
                              "target_lang": "en"} -> both streams from ONE
                              encoder pass + fused dual-prompt search
    POST /v1/speaker_turns   {"audio": ...}
    POST /v1/long_form       {"audio": <whole conversation>, ...} -> VAD
                              segmentation + fused dual decode + merged
                              texts + absolute-time RTTM (engine.long_form)
    GET  /healthz            {"status": "ok"}
    GET  /stats              coalescing counters from the front end

Each request blocks on its Future, so concurrent HTTP clients are exactly
the traffic the coalescer batches: the ThreadingHTTPServer thread-per-
request model feeds the single worker, which groups arrivals per
(task, language pair) into one engine call (serving_stream.py). Any front
end with ``submit``/``stats``/``start``/``close`` serves, the
``ContinuousBatchingEngine`` too (translate and transcribe only: its other
tasks answer 400).

Status codes: 400 for a malformed body or a task the front end does not
serve, 404 for an unknown path, 503 once the front end is closed, 504 when
the answer takes longer than ``request_timeout``.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from concurrent import futures as _futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .serving_stream import StreamingFrontEnd

logger = logging.getLogger(__name__)

__all__ = ["STHttpServer", "serve_forever"]

_ROUTES = {
    "/v1/translate": "translate",
    "/v1/transcribe": "transcribe",
    "/v1/transcribe_translate": "transcribe_translate",
    "/v1/speaker_turns": "speaker_turns",
    "/v1/long_form": "long_form",
}


def _decode_audio(payload: dict) -> np.ndarray:
    if "audio" in payload:
        return np.asarray(payload["audio"], np.float32)
    if "audio_b64" in payload:
        raw = base64.b64decode(payload["audio_b64"])
        return np.frombuffer(raw, np.float32).copy()
    if "audio_pcm16_b64" in payload:
        # PCM16 wire format: half the payload bytes; the engine unpacks
        # on device when transfer_dtype="int16" (or on host otherwise)
        raw = base64.b64decode(payload["audio_pcm16_b64"])
        return np.frombuffer(raw, np.int16).copy()
    raise ValueError("request needs 'audio' (list of floats), "
                     "'audio_b64' (base64 float32 LE) or "
                     "'audio_pcm16_b64' (base64 int16 LE)")


class _Handler(BaseHTTPRequestHandler):
    server_version = "stac-st-torch"
    front: StreamingFrontEnd  # injected via handler subclass
    request_timeout: float

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s " + fmt, self.client_address[0], *args)

    def _reply(self, code: int, obj) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            return self._reply(200, {"status": "ok"})
        if self.path == "/stats":
            return self._reply(200, self.front.stats())
        return self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        task = _ROUTES.get(self.path)
        if task is None:
            return self._reply(404, {"error": f"unknown path {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            wav = _decode_audio(payload)
            if wav.ndim != 1 or wav.size == 0:
                raise ValueError("audio must be a non-empty 1-D waveform")
        except (ValueError, json.JSONDecodeError) as exc:
            return self._reply(400, {"error": str(exc)})
        try:
            fut = self.front.submit(
                wav, task=task,
                source_lang=payload.get("source_lang"),
                target_lang=payload.get("target_lang"),
            )
            result = fut.result(timeout=self.request_timeout)
        except ValueError as exc:  # task unsupported by this front end
            return self._reply(400, {"error": str(exc)})
        except RuntimeError as exc:  # front end closed
            return self._reply(503, {"error": str(exc)})
        # concurrent.futures.TimeoutError is only an alias of the builtin
        # from Python 3.11; catch both so 3.10 maps timeouts to 504 too
        except (TimeoutError, _futures.TimeoutError):
            return self._reply(504, {"error": "decode timed out"})
        if task == "speaker_turns":
            return self._reply(200, {"events": result})
        if task in ("transcribe_translate", "long_form"):
            return self._reply(200, result)  # result is already a dict
        return self._reply(200, {"text": result})


class STHttpServer:
    """Serve an STEngine (or an existing StreamingFrontEnd) over HTTP.

    ::

        server = STHttpServer(engine, port=8080)
        server.start()          # background thread; server.port is bound
        ...
        server.close()

    ``port=0`` binds an ephemeral port (read it back from ``.port``).

    Deployment note: the HTTP thread is a daemon, so a bare SIGTERM does
    not stop an otherwise-idle process; call :meth:`close` from your
    signal handler (or use :func:`serve_forever` below, which installs
    one) for graceful shutdown.
    """

    def __init__(self, engine_or_front, host: str = "127.0.0.1",
                 port: int = 8080, request_timeout: float = 300.0,
                 **front_kwargs):
        # anything exposing submit() is already a front end (the batch
        # StreamingFrontEnd or the ContinuousBatchingEngine); a bare
        # STEngine gets wrapped in the batch front end
        if hasattr(engine_or_front, "submit"):
            self.front = engine_or_front
            self._owns_front = False
        else:
            self.front = StreamingFrontEnd(engine_or_front, **front_kwargs)
            self._owns_front = True

        front = self.front

        class Handler(_Handler):
            pass

        Handler.front = front
        Handler.request_timeout = float(request_timeout)
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "STHttpServer":
        self.front.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="st-http-server",
        )
        self._thread.start()
        logger.info("serving on %s:%d", *self._httpd.server_address[:2])
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._owns_front:
            self.front.close()

    def __enter__(self) -> "STHttpServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve_forever(engine, host: str = "127.0.0.1", port: int = 8080,
                  **kwargs) -> None:
    """Blocking entry point with graceful SIGTERM/SIGINT shutdown."""
    import signal
    import time

    server = STHttpServer(engine, host=host, port=port, **kwargs).start()
    done = threading.Event()

    def _stop(signum, frame):
        logger.info("signal %d: shutting down", signum)
        done.set()

    previous = {sig: signal.signal(sig, _stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        while not done.is_set():
            time.sleep(0.5)
    finally:
        for sig, handler in previous.items():  # leave the caller's
            signal.signal(sig, handler)
        server.close()
