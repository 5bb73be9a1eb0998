#!/usr/bin/env python3
"""Serve a trained experiment over HTTP with the port.

Port of ``recipes/serve.py``. Loads the experiment from its own saved
config (no model dims re-specified), builds the batched
:class:`~stac_st_tpu_torch.serving.STEngine` on the card, and exposes it
through one front end: the coalescing :class:`StreamingFrontEnd` over the
beam search (every route: translate, transcribe, transcribe_translate,
speaker_turns, long_form), or with ``--continuous`` the greedy slot loop
(:class:`ContinuousBatchingEngine`; translate and transcribe, optionally
finalized by the beam search with ``--protocol-finalize``).

Usage::

    python -m stac_st_tpu_torch.recipes.serve results/transformer_multitask/8886 \\
        --http-port 8080 [--continuous] [--kv-cache-dtype int8] \\
        [--weights-int8] [--data-parallel N|-1] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given. ``--kv-cache-dtype
int8`` and ``--weights-int8`` reach the engine (the int8 KV cache, int8
decode weights) under either front. ``--data-parallel N`` serves over
the first N visible cards (``-1``: all of them; one card, or 0/1, serves
without a mesh; N above the visible count exits), both fronts; with
``--device cpu`` the N shards share the CPU. What the port does not
serve yet raises, naming the flag: ``--transport grpc|both`` and
``--grpc-port`` (the gRPC adapter). The reference's
``--compile-cache`` persists XLA executables and means nothing here (the
port compiles its CUDA kernels once per checkout into
``build/torch_kernels/``), so the parser has no such flag.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time

logger = logging.getLogger("serve")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("experiment_dir",
                   help="training experiment directory (hyperparams.yaml + "
                        "save/)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer .model path (default: from the saved "
                        "config)")
    p.add_argument("--transport", choices=("http", "grpc", "both"),
                   default="http")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--grpc-port", type=int, default=None,
                   help="gRPC port (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    # engine knobs (defaults mirror STEngine)
    p.add_argument("--source-lang", default="es")
    p.add_argument("--target-lang", default="en")
    p.add_argument("--beam-size", type=int, default=10)
    p.add_argument("--max-decode-tokens", type=int, default=192)
    p.add_argument("--buckets", default="2,4,8,16,32",
                   help="comma-separated bucket seconds")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard request batches over this many cards "
                        "(0/1 = single device, -1 = all)")
    p.add_argument("--no-bf16", action="store_true",
                   help="keep fp32 weights and activations")
    p.add_argument("--avg-checkpoints", type=int, default=None,
                   help="average the top-N saved checkpoints by ACC "
                        "(default: every kept one)")
    # front-end knobs
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--pad-batch", type=str, default=None,
                   help="pad engine batches: one int = round rows up to a "
                        "multiple; a comma ladder like '4,16' = pad to the "
                        "smallest rung >= the formed batch. Default: "
                        "--max-batch")
    p.add_argument("--kv-cache-dtype", choices=("int8",), default=None,
                   help="decode with the int8 KV cache (per-(row, head, "
                        "position) fp32 scales)")
    p.add_argument("--weights-int8", action="store_true",
                   help="weight-only int8 on the decode path (decoder "
                        "projections, FFN, seq_lin; fp32 scales)")
    p.add_argument("--continuous", action="store_true",
                   help="serve through the continuous batching engine: a "
                        "persistent greedy decode loop over --slots slots "
                        "(translate/transcribe routes only)")
    p.add_argument("--slots", type=int, default=8,
                   help="continuous mode: decode-loop width (rows a step)")
    p.add_argument("--chunk", type=int, default=16,
                   help="continuous mode: decode steps between host reads")
    p.add_argument("--admit-rungs", default=None,
                   help="continuous mode: comma-separated admission group "
                        "sizes (default: 1,4,<slots>)")
    p.add_argument("--protocol-finalize", action="store_true",
                   help="continuous mode: re-decode each finished draft "
                        "through the beam search and answer with that")
    p.add_argument("--max-wait-ms", type=float, default=20.0)
    p.add_argument("--request-timeout", type=float, default=300.0)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip serving every (bucket x pad-rung) shape once "
                        "before binding ports")
    p.add_argument("--warmup-dual", action="store_true",
                   help="also warm transcribe_and_translate per shape")
    p.add_argument("--log-level", default="INFO")
    return p


def _parse_pad_batch(spec: str):
    """'16' -> 16 (round-up multiple); '4,16' -> (4, 16) ladder."""
    parts = [int(s) for s in str(spec).split(",") if s.strip()]
    if not parts:
        raise ValueError(f"--pad-batch: no row counts in {spec!r}")
    return parts[0] if len(parts) == 1 else tuple(parts)


def refuse_unported(args) -> None:
    """Raise ``ValueError`` naming the first flag the port cannot honour
    and the work it waits for."""
    if args.transport != "http":
        raise ValueError(f"--transport {args.transport}: the port serves "
                         "http only; the gRPC adapter is a later slice")
    if args.grpc_port is not None:
        raise ValueError(f"--grpc-port {args.grpc_port}: the port serves "
                         "http only; the gRPC adapter is a later slice")


def data_mesh(args):
    """The ``DataMesh`` ``--data-parallel`` asks for, or None."""
    import torch

    from stac_st_tpu_torch.parallel.mesh import make_mesh

    if args.data_parallel in (0, 1):
        return None
    if torch.device(args.device).type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [f"cuda:{i}" for i in range(n)]
    else:  # CPU shards share the host
        devs = [args.device] * max(args.data_parallel, 1)
    n = len(devs) if args.data_parallel == -1 else args.data_parallel
    if not 1 <= n <= len(devs):
        raise SystemExit(
            f"--data-parallel {args.data_parallel}: need a value in "
            f"[2, {len(devs)}] (or -1 for all devices); {len(devs)} "
            f"device(s) visible")
    if n == 1:
        # -1 on a one-card host serves without a mesh
        logger.info("fleet serving asked for, 1 device visible: serving "
                    "single-device")
        return None
    logger.info("fleet serving over %d devices", n)
    return make_mesh(n, devs)


def start_servers(args):
    """Load the experiment and start the HTTP server.

    Returns ``(front, server)``: the front end and the started
    :class:`STHttpServer` (its bound port is ``server.port``). Split from
    :func:`main` so a caller can drive the whole path with ephemeral ports
    and close it without signals.
    """
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.serving_http import STHttpServer
    from stac_st_tpu_torch.serving_stream import StreamingFrontEnd

    refuse_unported(args)
    kw = dict(
        source_lang=args.source_lang,
        target_lang=args.target_lang,
        beam_size=args.beam_size,
        max_decode_tokens=args.max_decode_tokens,
        bucket_seconds=tuple(
            float(s) for s in args.buckets.split(",") if s.strip()),
        bf16=not args.no_bf16,
        pad_batch_rows=(_parse_pad_batch(args.pad_batch)
                        if args.pad_batch is not None else args.max_batch),
        device=args.device,
        avg_checkpoints=args.avg_checkpoints,
        kv_cache_dtype=args.kv_cache_dtype,
        weights_int8=args.weights_int8,
        mesh=data_mesh(args),
    )
    logger.info("loading experiment %s", args.experiment_dir)
    engine = STEngine.from_saved_experiment(
        args.experiment_dir, tokenizer_file=args.tokenizer, **kw)

    t0 = time.perf_counter()
    if args.continuous:
        from stac_st_tpu_torch.serving_continuous import (
            ContinuousBatchingEngine,
        )

        rungs = (tuple(int(s) for s in args.admit_rungs.split(",")
                       if s.strip())
                 if args.admit_rungs else None)
        front = ContinuousBatchingEngine(
            engine, slots=args.slots, chunk=args.chunk,
            max_new_tokens=args.max_decode_tokens, admit_rungs=rungs,
            protocol_finalize=args.protocol_finalize)
        if not args.no_warmup:
            n = front.warmup()
            if args.protocol_finalize:
                engine.warmup()
            logger.info("warmed %d continuous-mode shapes in %.1fs",
                        n, time.perf_counter() - t0)
    else:
        if not args.no_warmup:
            # serve every (bucket x rung) shape before binding the port, so
            # no request pays a first call's set-up
            n = engine.warmup(dual=args.warmup_dual)
            logger.info("warmed %d (bucket x rung) shapes in %.1fs",
                        n, time.perf_counter() - t0)
        front = StreamingFrontEnd(
            engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)

    server = STHttpServer(front, host=args.host, port=args.http_port,
                          request_timeout=args.request_timeout)
    server.start()
    logger.info("%s listening on %s:%d",
                type(server).__name__, args.host, server.port)
    return front, server


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    front, server = start_servers(args)

    done = threading.Event()

    def _stop(signum, frame):
        logger.info("signal %d: shutting down", signum)
        done.set()

    previous = {sig: signal.signal(sig, _stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        done.wait()
    finally:
        for sig, handler in previous.items():  # leave the caller's
            signal.signal(sig, handler)
        server.close()
        front.close()


if __name__ == "__main__":
    main()
