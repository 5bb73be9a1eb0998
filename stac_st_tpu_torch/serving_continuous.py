"""Continuous (in-flight) batching: a persistent greedy decode loop over slots.

Port of ``stac_st_tpu/serving_continuous.py``. The coalescing front end
(``serving_stream.py``) decodes each formed batch to completion, so one long
utterance holds every row of its batch, and a request arriving just after a
batch forms waits out the whole engine call. Here a fixed pool of ``slots``
decodes greedily in lock-step, and whenever a slot finishes (eos or budget)
the host swaps a queued request into it between chunks while the other
slots keep generating.

* ONE batched step over all R slots. Each slot sits at its own decode
  depth: every layer's self-cache index is an (R,) int32 device tensor, the
  append writes each row at its own index and the self kernel
  (``decode_self_attention``'s ragged form) reads each row's positions up
  to its index (``TransformerMultiTask.decode_step_rows``).
* A CHUNK is ``chunk`` eager steps with all slot state on the device; the
  host reads the emitted tokens and done flags once per chunk, never inside
  one. A finished slot keeps riding the batched step (its index keeps
  growing; the append at an index past the cache writes nothing) and emits
  the -1 sentinel until it is refilled at a chunk boundary.
* ADMISSION is batched: queued requests are grouped by audio bucket and
  admitted in groups of an admit rung (default 1, 4, slots; padded to the
  rung with silent rows, as the reference pads them): encode the group,
  pad the encoder output to the largest bucket's frame count ``S_max``,
  build each row's cross-attention bias from ``floor(len · S_w)`` (frames
  past it masked), prime the three-token language prompt through
  ``decode_window``, take the first token from the prompt's last position,
  and scatter the valid rows into their slots, whole rows of every cache
  tensor (self K/V and index, cross K/V, their scales with the int8 cache,
  bias, position, last token, done, count and budget), so nothing of a
  slot's previous occupant is read. Padding rows are never scattered.
* The engine's int8 options carry over: int8 weights drive every step,
  and with the int8 cache the chunk step runs the ragged int8 self
  kernel and the int8 cross kernel.
* Over an engine's mesh (``STEngine(mesh=...)``) the slot pool is sharded
  on its rows: ``slots`` must be a multiple of the shard count d, and
  shard k holds slots ``k·R/d ..`` on its device, beside its replica of
  the modules. An admission group is encoded and primed on the device of
  the shard that owns most of its slots, and each row is scattered onto
  the shard that owns its slot; a request takes a free slot of the shard
  with the most free slots (ties go round the shards). A chunk launches
  every step on every shard, shard after shard, before the one host read
  of the chunk.

Decoding in the slot loop is greedy (beam 1): one hypothesis per slot is
what makes slot swapping exact. For the reference's test protocol (beam 10,
eos threshold, length normalization, temperature 1.15),
``protocol_finalize=True`` makes the loop the draft tier: a finalizer
thread re-decodes finished utterances through the engine's beam search,
batched per language pair; the greedy draft reaches the caller early
(``submit(on_draft=...)``) and the future resolves with the engine's
``translate``/``transcribe`` text. Once the slot loop has stopped, the
finalizer drains its queue once more before it exits, so a draft queued
just before the loop ended is finalized, not failed by ``close()``.

Worker threads enter ``torch.inference_mode`` themselves (it is
thread-local) and share the default CUDA stream of each device.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.masks import NEG_INF
from .parallel.mesh import device_scope

logger = logging.getLogger(__name__)

__all__ = ["ContinuousBatchingEngine"]

_PROMPT_LEN = 3  # [bos, src_lang, tgt_lang]


@dataclass
class _Request:
    wav: np.ndarray
    source_lang: str
    target_lang: str
    future: Future = field(default_factory=Future)
    on_draft: Optional[object] = None


class _Slot:
    """Host-side mirror of one device slot."""

    __slots__ = ("req", "tokens", "active")

    def __init__(self):
        self.req: Optional[_Request] = None
        self.tokens: List[int] = []
        self.active = False


class ContinuousBatchingEngine:
    """Slot-based continuous batching over an :class:`STEngine`'s model.

    ::

        cont = ContinuousBatchingEngine(engine, slots=8, chunk=16)
        fut = cont.submit(wav, task="translate")
        text = fut.result()
        cont.close()

    ``slots``: the loop's width R (idle slots still ride the batched step);
    ``chunk``: steps between host reads (a finished slot waits at most one
    chunk for refill); ``max_new_tokens``: the generation cap (default: the
    engine's), each slot's budget ``min(valid encoder frames, cap)``;
    ``admit_rungs``: admission group sizes (a queued burst admits at the
    smallest rung that fits; default 1, 4, ``slots``);
    ``protocol_finalize``: answer with the engine's beam search (above).
    """

    QUEUE_CAPACITY = 1024   # queued requests before submit() blocks
    FINALIZE_BATCH = 8      # drafts per finalizer engine call, at most
    FINALIZE_LINGER = 0.02  # seconds the finalizer waits to fill a call

    def __init__(self, engine, slots: int = 8, chunk: int = 16,
                 max_new_tokens: Optional[int] = None,
                 admit_rungs: Optional[Sequence[int]] = None,
                 protocol_finalize: bool = False):
        if slots < 1 or chunk < 1:
            raise ValueError("slots and chunk must be >= 1")
        mesh = getattr(engine, "mesh", None)
        devices = [engine.device] if mesh is None else list(mesh.devices)
        if int(slots) % len(devices):
            raise ValueError(
                f"slots={slots} must be a multiple of the mesh's data-axis "
                f"size {len(devices)}: the slot pool is sharded on its row "
                f"axis across the mesh")
        # (device, the engine's modules there) of each shard
        self._shards = [(dev, engine._replicas[dev]) for dev in devices]
        self._per = int(slots) // len(devices)
        self._next_shard = 0  # where a tie between shards goes next
        self.engine = engine
        self.kv_cache_dtype = engine.searcher.kv_cache_dtype
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.eos = int(engine.searcher.config.eos_index)
        self.bos = int(engine.searcher.bos_token)
        self.cap = int(max_new_tokens or engine.searcher.max_decode_tokens
                       or 192)
        if admit_rungs is None:
            admit_rungs = (1, 4, self.slots)
        rungs = sorted({int(r) for r in admit_rungs
                        if 1 <= int(r) <= self.slots})
        if not rungs:
            raise ValueError(f"admit_rungs {admit_rungs!r}: no rung in "
                             f"[1, slots={self.slots}]")
        if rungs[-1] != self.slots:
            rungs.append(self.slots)  # a full-pool burst must fit one call
        self._admit_rungs: Tuple[int, ...] = tuple(rungs)
        self._widths = [int(b * engine.sample_rate) for b in engine.buckets]
        self._states = [self._init_state(k) for k in range(len(devices))]

        # ------------------------------------------------- host-side loop
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            self.QUEUE_CAPACITY)
        self._slots = [_Slot() for _ in range(self.slots)]
        self._free = list(range(self.slots))
        self._closing = threading.Event()
        self._pause_req = threading.Event()
        self._pause_ack = threading.Event()
        self._stats: Dict[str, float] = {
            "submitted": 0, "completed": 0, "chunks": 0, "admits": 0,
            "admit_calls": 0, "tokens": 0, "active_slot_steps": 0,
            "slot_steps": 0,
        }
        self._lock = threading.Lock()

        self.protocol_finalize = bool(protocol_finalize)
        self._final_q: "queue.Queue[tuple]" = queue.Queue()
        self._finalizer: Optional[threading.Thread] = None
        if self.protocol_finalize:
            self._stats.update({"finalized": 0, "draft_exact": 0})
            self._finalizer = threading.Thread(
                target=self._finalize_loop, name="protocol-finalizer",
                daemon=True)
            self._finalizer.start()

        self._worker = threading.Thread(
            target=self._run, name="continuous-batching", daemon=True)
        self._worker.start()

    # ------------------------------------------------------ device state
    @torch.inference_mode()
    def _init_state(self, k: int) -> Dict:
        """Shard ``k``'s part of the slot pool: every slot done, caches
        sized for the prompt and the cap, cross K/V at ``S_max`` (the
        largest bucket's encoder frames, found by encoding one silent row
        of it)."""
        dev, rep = self._shards[k]
        R, cap = self._per, _PROMPT_LEN + self.cap
        with device_scope(dev):
            probe = self.engine._encode(
                torch.zeros((1, self._widths[-1]), device=dev),
                torch.ones((1,), device=dev), rep)
            self._S_max = S_max = probe.shape[1]
            enc0 = torch.zeros((R, S_max, probe.shape[2]),
                               dtype=probe.dtype, device=dev)
            bias0 = torch.full((R, S_max), NEG_INF, device=dev)
            cache = rep.transformer.init_decode_cache(
                enc0, cap, bias0, cache_dtype=self.kv_cache_dtype)
        for layer in cache["layers"]:
            layer["self"]["index"] = torch.zeros((R,), dtype=torch.int32,
                                                 device=dev)
        zeros = dict(dtype=torch.int32, device=dev)
        return {
            "layers": cache["layers"],
            "enc_bias": cache["enc_bias"],
            "pos": torch.zeros((R,), **zeros),
            "last": torch.zeros((R,), dtype=torch.long, device=dev),
            "done": torch.ones((R,), dtype=torch.bool, device=dev),
            "gen": torch.zeros((R,), **zeros),
            "budget": torch.zeros((R,), **zeros),
        }

    def _admit_batch(self, slot_ids: List[int], wavs: np.ndarray,
                     lens: np.ndarray, prompts: np.ndarray):
        """Encode and prompt-prime a group of ``len(wavs)`` (a rung) rows
        on the shard that owns most of ``slot_ids``; scatter the first
        ``len(slot_ids)`` into those slots, each onto its own shard.
        Returns the first tokens and done flags of the scattered rows, on
        the host."""
        owners = [s // self._per for s in slot_ids]
        k0 = max(set(owners), key=owners.count) if owners else 0
        dev, rep = self._shards[k0]
        with device_scope(dev):
            return self._admit_on(rep, dev, slot_ids, owners, wavs, lens,
                                  prompts)

    def _admit_on(self, rep, dev, slot_ids, owners, wavs, lens, prompts):
        eng = self.engine
        model = rep.transformer
        S_max = self._S_max
        lens_d = torch.from_numpy(lens).to(dev)
        enc = eng._encode(torch.from_numpy(wavs).to(dev), lens_d,
                          rep)  # (A, S_w, d)
        S_w = enc.shape[1]
        # the reference's mask against the native frame count, then every
        # padded column masked too
        abs_len = torch.floor(lens_d * S_w)
        bias = torch.where(
            torch.arange(S_max, device=dev)[None, :] > abs_len[:, None],
            NEG_INF, 0.0)
        enc_p = torch.nn.functional.pad(enc, (0, 0, 0, S_max - S_w))
        cache = model.init_decode_cache(enc_p, _PROMPT_LEN + self.cap, bias,
                                        cache_dtype=self.kv_cache_dtype)
        hidden = model.decode_window(
            torch.from_numpy(prompts).to(dev), 0, cache)  # (A, P, d)
        first = torch.argmax(rep.seq_lin(hidden[:, -1, :]), dim=-1)
        budget = torch.clamp(abs_len.to(torch.int32) + 1, max=self.cap)
        is_eos = first == self.eos
        gen0 = torch.where(is_eos, 0, 1).to(torch.int32)
        done0 = is_eos | (gen0 >= budget)

        n = len(slot_ids)
        for k in sorted(set(owners)):
            dev_k = self._shards[k][0]
            rows = [i for i in range(n) if owners[i] == k]
            src = torch.tensor(rows, dtype=torch.long, device=dev)

            def take(x):
                return x[src].to(dev_k)

            with device_scope(dev_k):
                self._scatter(self._states[k], torch.tensor(
                    [slot_ids[i] % self._per for i in rows],
                    dtype=torch.long, device=dev_k), cache, take,
                    first, done0, gen0, budget)
        return first[:n].cpu().numpy(), done0[:n].cpu().numpy()

    @staticmethod
    def _scatter(st, tgt, cache, take, first, done0, gen0, budget) -> None:
        """Whole rows of every slot tensor of ``st`` at ``tgt`` from the
        primed rows ``take`` picks."""
        for big, row in zip(st["layers"], cache["layers"]):
            for name, leaf in row["self"].items():  # K, V (and scales)
                if name != "index":
                    big["self"][name][tgt] = take(leaf)
            big["self"]["index"][tgt] = _PROMPT_LEN
            for name in ("cross_k", "cross_v", "cross_k_scale",
                         "cross_v_scale"):
                if name in row:
                    big[name][tgt] = take(row[name])
        st["enc_bias"][tgt] = take(cache["enc_bias"])
        st["pos"][tgt] = _PROMPT_LEN
        st["last"][tgt] = take(first)
        st["done"][tgt] = take(done0)
        st["gen"][tgt] = take(gen0)
        st["budget"][tgt] = take(budget)

    def _step_chunk(self):
        """Advance every slot ``chunk`` greedy steps; returns the emitted
        tokens (R, chunk) (-1 where a slot emitted nothing) and the done
        flags, read on the host once (each shard's, after every shard's
        steps were launched)."""
        emits: List[List[torch.Tensor]] = [[] for _ in self._shards]
        for _ in range(self.chunk):
            for (dev, rep), st, out in zip(self._shards, self._states,
                                           emits):
                with device_scope(dev):
                    out.append(self._step(rep, st))
        return (np.concatenate([torch.stack(e, dim=1).cpu().numpy()
                                for e in emits]),
                np.concatenate([st["done"].cpu().numpy()
                                for st in self._states]))

    def _step(self, rep, st) -> torch.Tensor:
        """One greedy step of a shard's slots; returns its emits."""
        cache = {"layers": st["layers"], "enc_bias": st["enc_bias"]}
        hidden = rep.transformer.decode_step_rows(st["last"], st["pos"],
                                                  cache)
        nxt = torch.argmax(rep.seq_lin(hidden), dim=-1)
        active = ~st["done"]
        is_eos = nxt == self.eos
        emit_ok = active & ~is_eos
        st["gen"] = st["gen"] + emit_ok.to(torch.int32)
        st["done"] = st["done"] | (active & is_eos) | (
            st["gen"] >= st["budget"])
        st["pos"] = torch.where(active, st["pos"] + 1, st["pos"])
        st["last"] = torch.where(emit_ok, nxt, st["last"])
        return torch.where(emit_ok, nxt, -1)

    # ----------------------------------------------------------------- API
    def start(self) -> None:
        """Front-end protocol no-op: the slot loop starts at construction,
        so the engine drops into :class:`~.serving_http.STHttpServer`
        wherever a :class:`~.serving_stream.StreamingFrontEnd` is
        expected."""

    def stats(self) -> Dict[str, float]:
        """Snapshot of loop counters (front-end protocol)."""
        with self._lock:
            snap = dict(self._stats)
        snap["queued"] = self._queue.qsize()
        snap["active_slots"] = sum(1 for s in self._slots if s.active)
        total = snap["slot_steps"]
        snap["utilization"] = (
            snap["active_slot_steps"] / total if total else 0.0)
        return snap

    @torch.inference_mode()
    def warmup(self) -> int:
        """Serve every (bucket, admit rung) admission shape once and one
        chunk before traffic: the kernels' first launches, cuBLAS and cuDNN
        set-up. The worker is held meanwhile; each admission is an
        all-padding group (nothing is scattered), and the chunk's emits are
        collected as any chunk's. Returns the number of shapes served."""
        n = 0
        with self._pause_worker():
            for width in self._widths:
                for rung in self._admit_rungs:
                    self._admit_batch(
                        [], np.zeros((rung, width), np.float32),
                        np.ones((rung,), np.float32),
                        np.full((rung, _PROMPT_LEN), self.bos, np.int64))
                    n += 1
            self._advance_chunk(
                [i for i, sl in enumerate(self._slots) if sl.active])
            n += 1
        return n

    def submit(self, wav: np.ndarray, task: str = "translate",
               source_lang: Optional[str] = None,
               target_lang: Optional[str] = None,
               on_draft=None) -> Future:
        """Enqueue one utterance; the Future resolves to the decoded text.

        ``task``: 'translate' (src→tgt) or 'transcribe' (src→src).
        ``on_draft``: with ``protocol_finalize``, called with the greedy
        draft text as soon as the slot loop finishes it (the future then
        resolves later with the protocol search's text)."""
        if self._closing.is_set():
            raise RuntimeError("engine is closed")
        src = source_lang or self.engine.source_lang
        if task == "translate":
            tgt = target_lang or self.engine.target_lang
        elif task == "transcribe":
            tgt = src
        else:
            raise ValueError(
                f"the continuous engine serves translate|transcribe; "
                f"{task!r} needs the batch front end "
                f"(serving_stream.StreamingFrontEnd)")
        wav = np.asarray(wav)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        else:
            wav = wav.astype(np.float32)
        req = _Request(wav=wav, source_lang=src, target_lang=tgt,
                       on_draft=on_draft)
        self._queue.put(req)
        with self._lock:
            self._stats["submitted"] += 1
        return req.future

    def translate(self, wavs, source_lang=None, target_lang=None):
        futs = [self.submit(w, "translate", source_lang, target_lang)
                for w in wavs]
        return [f.result() for f in futs]

    def transcribe(self, wavs, source_lang=None):
        futs = [self.submit(w, "transcribe", source_lang) for w in wavs]
        return [f.result() for f in futs]

    def close(self, timeout: float = 60.0) -> None:
        """Drain in-flight work, then stop the worker (and finalizer)."""
        self._closing.set()
        self._worker.join(timeout)
        if self._finalizer is not None:
            self._finalizer.join(timeout)
            # the finalizer died or timed out with work pending
            while True:
                try:
                    req, _draft = self._final_q.get_nowait()
                except queue.Empty:
                    break
                req.future.set_exception(RuntimeError("engine closed"))
        # anything still queued after the drain window fails loudly
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.future.set_exception(RuntimeError("engine closed"))

    def utilization(self) -> float:
        """Mean fraction of slot-steps that carried an active request."""
        with self._lock:
            total = self._stats["slot_steps"]
            return (self._stats["active_slot_steps"] / total
                    ) if total else 0.0

    # ------------------------------------------------------------- worker
    @contextlib.contextmanager
    def _pause_worker(self):
        """Hold the worker at its loop top so device state can be touched
        from another thread (warmup)."""
        self._pause_req.set()
        try:
            while (self._worker.is_alive()
                   and not self._pause_ack.wait(timeout=0.1)):
                pass
            yield
        finally:
            self._pause_req.clear()

    def _prompt_ids(self, src: str, tgt: str) -> List[int]:
        sp = self.engine.tokenizer
        return [self.bos, sp.encode_as_ids(f"[{src}]")[-1],
                sp.encode_as_ids(f"[{tgt}]")[-1]]

    def _admit_many(self, reqs: List[_Request]) -> None:
        """Admit queued requests into free slots: group by bucket width,
        one admission per (bucket, rung) group."""
        eng = self.engine
        nfree = len(self._free)
        if len(reqs) > nfree:  # e.g. the idle wake-up plus a full drain
            for req in reqs[nfree:]:
                self._queue.put(req)
            reqs = reqs[:nfree]
        groups: Dict[int, List[_Request]] = {}
        for req in reqs:
            groups.setdefault(eng._bucket_width(len(req.wav)),
                              []).append(req)
        for width, grp in groups.items():
            while grp:
                rung = next(r for r in self._admit_rungs
                            if r >= min(len(grp), self._admit_rungs[-1]))
                take, grp = grp[:rung], grp[rung:]
                try:
                    self._admit_group(width, rung, take)
                except Exception as e:
                    logger.exception("admit failed (width=%d rung=%d)",
                                     width, rung)
                    for req in take:
                        req.future.set_exception(e)

    def _admit_group(self, width: int, rung: int,
                     take: List[_Request]) -> None:
        n = len(take)
        wavs = np.zeros((rung, width), np.float32)
        lens = np.ones((rung,), np.float32)
        prompts = np.full((rung, _PROMPT_LEN), self.bos, np.int64)
        assigned: List[int] = []
        try:
            for i, req in enumerate(take):
                wavs[i, : len(req.wav)] = req.wav
                lens[i] = len(req.wav) / width
                prompts[i] = self._prompt_ids(req.source_lang,
                                              req.target_lang)
                assigned.append(self._take_free())
            first, done0 = self._admit_batch(assigned, wavs, lens, prompts)
        except Exception:
            # a failed group must not leak its slots: nothing was
            # activated, so every popped slot returns to the free list
            self._free.extend(assigned)
            raise
        with self._lock:
            self._stats["admits"] += n
            self._stats["admit_calls"] += 1
        for i, (req, s) in enumerate(zip(take, assigned)):
            slot = self._slots[s]
            slot.req, slot.tokens, slot.active = req, [], True
            tok = int(first[i])
            if tok != self.eos:
                slot.tokens.append(tok)
            if bool(done0[i]):
                self._finish(s)

    def _take_free(self) -> int:
        """A free slot: on one device the last freed one; over a mesh the
        last free slot of the shard with the most free slots, ties going
        round the shards, so requests spread over them."""
        d = len(self._shards)
        if d == 1:
            return self._free.pop()
        free = [[s for s in self._free if s // self._per == k]
                for k in range(d)]
        k = max(((self._next_shard + j) % d for j in range(d)),
                key=lambda i: len(free[i]))
        self._next_shard = (k + 1) % d
        self._free.remove(free[k][-1])
        return free[k][-1]

    def _finish(self, s: int) -> None:
        slot = self._slots[s]
        req, tokens = slot.req, slot.tokens
        slot.req, slot.tokens, slot.active = None, [], False
        self._free.append(s)
        with self._lock:
            self._stats["completed"] += 1
            self._stats["tokens"] += len(tokens)
        try:
            text = self.engine.tokenizer.decode_ids(tokens)
        except Exception as e:  # tokenizer failure must not kill the loop
            req.future.set_exception(e)
            return
        if self.protocol_finalize:
            if req.on_draft is not None:
                try:
                    req.on_draft(text)
                except Exception:  # user callback must not kill the loop
                    logger.exception("on_draft callback failed")
            self._final_q.put((req, text))
        else:
            req.future.set_result(text)

    # ------------------------------------------------ protocol finalizer
    @torch.inference_mode()
    def _finalize_loop(self) -> None:
        """Batch finished drafts through the engine's beam search, grouped
        by (source_lang, target_lang) so each engine call carries one
        prompt; the engine buckets by audio width itself."""
        while True:
            try:
                first = self._final_q.get(timeout=0.05)
            except queue.Empty:
                if not (self._closing.is_set()
                        and not self._worker.is_alive()):
                    continue
                # the slot loop has exited: every draft it queued is in
                # the queue now, including one queued after the get above
                # timed out, so drain once more before returning
                try:
                    first = self._final_q.get_nowait()
                except queue.Empty:
                    return
            batch = [first]
            deadline = time.monotonic() + self.FINALIZE_LINGER
            while len(batch) < self.FINALIZE_BATCH:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._final_q.get(timeout=remaining))
                except queue.Empty:
                    break
            groups: Dict[Tuple[str, str], List[tuple]] = {}
            for req, draft in batch:
                groups.setdefault(
                    (req.source_lang, req.target_lang), []
                ).append((req, draft))
            for (src, tgt), items in groups.items():
                try:
                    finals = self.engine.translate(
                        [r.wav for r, _ in items],
                        source_lang=src, target_lang=tgt)
                except Exception as e:
                    for req, _ in items:
                        req.future.set_exception(e)
                    continue
                exact = 0
                for (req, draft), final in zip(items, finals):
                    exact += final == draft
                    req.future.set_result(final)
                with self._lock:
                    self._stats["finalized"] += len(items)
                    self._stats["draft_exact"] += exact

    def _drain_queue(self) -> List[_Request]:
        """Pop up to len(free) queued requests without blocking."""
        reqs: List[_Request] = []
        while len(reqs) < len(self._free):
            try:
                reqs.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return reqs

    def _advance_chunk(self, active: List[int]) -> None:
        emits, done = self._step_chunk()
        with self._lock:
            self._stats["chunks"] += 1
            self._stats["slot_steps"] += self.slots * self.chunk
            self._stats["active_slot_steps"] += len(active) * self.chunk
        for s in active:
            toks = emits[s]
            self._slots[s].tokens.extend(int(t) for t in toks[toks >= 0])
            if done[s]:
                self._finish(s)

    @torch.inference_mode()
    def _run(self) -> None:
        while True:
            if self._pause_req.is_set():
                self._pause_ack.set()
                while (self._pause_req.is_set()
                       and not self._closing.is_set()):
                    time.sleep(0.001)
                self._pause_ack.clear()
            # refill free slots from the queue (grouped batched admits)
            reqs = self._drain_queue()
            if reqs:
                self._admit_many(reqs)
            active = [i for i, sl in enumerate(self._slots) if sl.active]
            if not active:
                if self._closing.is_set():
                    return
                try:
                    req = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                # merge the woken request with any burst right behind it
                self._admit_many([req] + self._drain_queue())
                continue
            # advance everyone by one chunk
            self._advance_chunk(active)
