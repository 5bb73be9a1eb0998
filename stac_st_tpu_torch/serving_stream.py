"""Streaming serving front end: request queue -> coalesced batches -> futures.

Port of ``stac_st_tpu/serving_stream.py``. ``STEngine`` (serving.py) is a
batch API: the caller owns batching. This module adds the front half (the
reference has no serving story at all — inference is the batch recipe
``stac-st/inference.py``):

* :class:`StreamingFrontEnd` — callers ``submit()`` single utterances from
  any thread and get ``concurrent.futures.Future`` handles; a worker thread
  coalesces whatever arrived within ``max_wait_ms`` (up to ``max_batch``)
  into one engine call per (task, language-pair) group, riding the engine's
  fixed bucket grid (and its pad-row ladder) so a formed batch meets a
  shape the warm-up already served.
* :class:`TurnStreamer` — incremental long-form speaker-turn events: feed
  audio chunks as they arrive; every full window is decoded by the CTC head
  and its [turn]/[xt] events are emitted with absolute timestamps.

Coalescing exists to feed the card wide batches: the decode loop's cost is
dominated by per-step launches and weight reads, which the beam search
amortizes over batch x beam. The worker runs under ``torch.inference_mode``
(thread-local, so it is entered in the thread itself); every worker shares
the default CUDA stream.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["StreamingFrontEnd", "TurnStreamer"]

_TASKS = ("translate", "transcribe", "transcribe_translate",
          "speaker_turns", "long_form")


@dataclass
class _Request:
    wav: np.ndarray
    task: str
    source_lang: Optional[str]
    target_lang: Optional[str]
    future: Future = field(default_factory=Future)


class StreamingFrontEnd:
    """Queue + coalescing worker in front of an :class:`STEngine`.

    ::

        front = StreamingFrontEnd(engine, max_batch=16, max_wait_ms=20)
        fut = front.submit(wav, task="translate")
        text = fut.result()
        front.close()

    Also usable as a context manager. ``stats()`` reports how well traffic
    coalesced (requests, batches, engine calls).
    """

    def __init__(self, engine, max_batch: int = 16, max_wait_ms: float = 20.0,
                 autostart: bool = True):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "engine_calls": 0,
                       "max_batch_seen": 0}
        self._batch_hist: Dict[int, int] = {}
        if autostart:
            self.start()

    # --------------------------------------------------------------- control
    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._closed = False
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="st-serving-worker")
        self._worker.start()

    def close(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` (default) finish queued work.
        Further ``submit()`` calls raise until ``start()`` is called again."""
        self._closed = True
        if self._worker is None:
            return
        if drain:
            self._queue.join()
        self._stop.set()
        self._worker.join(timeout=30.0)
        self._worker = None

    def __enter__(self) -> "StreamingFrontEnd":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------- API
    def submit(self, wav: np.ndarray, task: str = "translate",
               source_lang: Optional[str] = None,
               target_lang: Optional[str] = None) -> Future:
        if task not in _TASKS:
            raise ValueError(f"task must be one of {_TASKS}, got {task!r}")
        if self._closed:
            raise RuntimeError(
                "StreamingFrontEnd is closed; call start() to serve again"
            )
        wav = np.asarray(wav)
        if wav.dtype != np.int16:  # PCM16 passes through untouched
            wav = wav.astype(np.float32, copy=False)
        req = _Request(wav, task, source_lang, target_lang)
        with self._lock:
            self._stats["requests"] += 1
        self._queue.put(req)
        return req.future

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def batch_histogram(self) -> Dict[int, int]:
        """{formed batch size: count} — how traffic actually coalesced."""
        with self._lock:
            return dict(self._batch_hist)

    # ---------------------------------------------------------------- worker
    def _collect(self) -> List[_Request]:
        """Block for the first request, then drain for up to max_wait."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=timeout))
            except queue.Empty:
                break
        return batch

    @torch.inference_mode()
    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._dispatch(batch)
            finally:
                for _ in batch:
                    self._queue.task_done()

    def _dispatch(self, batch: List[_Request]) -> None:
        with self._lock:
            self._stats["batches"] += 1
            self._stats["max_batch_seen"] = max(
                self._stats["max_batch_seen"], len(batch)
            )
            self._batch_hist[len(batch)] = (
                self._batch_hist.get(len(batch), 0) + 1
            )
        groups: Dict[tuple, List[_Request]] = {}
        for req in batch:
            groups.setdefault(
                (req.task, req.source_lang, req.target_lang), []
            ).append(req)
        for (task, src, tgt), reqs in groups.items():
            wavs = [r.wav for r in reqs]
            try:
                if task == "translate":
                    results = self.engine.translate(
                        wavs, source_lang=src, target_lang=tgt)
                elif task == "transcribe":
                    results = self.engine.transcribe(wavs, source_lang=src)
                elif task == "transcribe_translate":
                    asr, st = self.engine.transcribe_and_translate(
                        wavs, source_lang=src, target_lang=tgt)
                    results = [
                        {"transcription": a, "translation": s}
                        for a, s in zip(asr, st)
                    ]
                elif task == "long_form":
                    # one conversation per request: the engine batches the
                    # VAD segments internally, so no cross-request fusion
                    results = [
                        self.engine.long_form(
                            w, source_lang=src, target_lang=tgt)
                        for w in wavs
                    ]
                else:
                    results = self.engine.speaker_turns(wavs)
                with self._lock:
                    self._stats["engine_calls"] += 1
                for r, res in zip(reqs, results):
                    r.future.set_result(res)
            except Exception as exc:  # pragma: no cover - engine failure path
                logger.exception("engine call failed for task %s", task)
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(exc)


class TurnStreamer:
    """Incremental speaker-turn events over a long-form audio stream.

    Feed chunks as they arrive; whenever a full ``window_seconds`` of
    unprocessed audio has accumulated, the window is decoded by the CTC head
    (`STEngine.speaker_turns`) and its [turn]/[xt] events are returned with
    ABSOLUTE stream timestamps. ``finish()`` flushes the remainder.

    Windows are non-overlapping, so each event is emitted exactly once;
    events falling within a frame of a window boundary may be attributed to
    either side (CTC spike timing is +-1 frame already; reference RTTM
    extraction has the same resolution, 25 fps).
    """

    def __init__(self, engine, window_seconds: float = 16.0):
        self.engine = engine
        self.window = int(window_seconds * engine.sample_rate)
        self._buf = np.zeros((0,), np.float32)
        self._offset_samples = 0  # absolute start of _buf in the stream

    @torch.inference_mode()
    def _emit(self, n_samples: int) -> Dict[str, List[float]]:
        window = self._buf[:n_samples]
        self._buf = self._buf[n_samples:]
        t0 = self._offset_samples / self.engine.sample_rate
        self._offset_samples += n_samples
        events = self.engine.speaker_turns([window])[0]
        return {name: [t0 + t for t in ts] for name, ts in events.items()}

    def feed(self, chunk: np.ndarray) -> List[Dict[str, List[float]]]:
        """Append audio; returns events for each window completed by it."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(chunk, np.float32)])
        out = []
        while len(self._buf) >= self.window:
            out.append(self._emit(self.window))
        return out

    def finish(self) -> List[Dict[str, List[float]]]:
        """Flush any buffered tail shorter than a window."""
        if len(self._buf) == 0:
            return []
        return [self._emit(len(self._buf))]
