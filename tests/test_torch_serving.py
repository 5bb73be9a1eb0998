"""The port's serving front on the CPU: segmentation and realignment
against the JAX package, the coalescing front end, the turn streamer,
every HTTP route and status code over both fronts, the serve recipe, and
the kernel layer's launch counts from several threads.

Tiny fixture (d32, 4 heads, 2 + 2 layers, vocab 150, CNN (16, 16)), fp32,
seeded numpy inputs. Results are compared exactly: texts and events with
the engine's direct calls on identical batches, segment lists and
realignments with the JAX functions.
"""

import base64
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import build_jax_tiny, build_port_twin  # noqa: E402

from stac_st_tpu_torch.eval import long_form as LF  # noqa: E402
from stac_st_tpu_torch.ops import kernels  # noqa: E402
from stac_st_tpu_torch.prep import shas  # noqa: E402
from stac_st_tpu_torch.serving_continuous import (  # noqa: E402
    ContinuousBatchingEngine,
)
from stac_st_tpu_torch.serving_http import STHttpServer  # noqa: E402
from stac_st_tpu_torch.serving_stream import (  # noqa: E402
    StreamingFrontEnd,
    TurnStreamer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def conversation(seed=0, bursts=(0.35, 0.5, 0.3, 0.55), pause=0.5):
    """Noise bursts (speech, about -8 dB) between quiet pauses (about
    -60 dB, below the energy VAD's thresholds, -55 dB at aggressiveness 0
    and -45 dB at 1)."""
    rng = np.random.default_rng(seed)
    parts = []
    for dur in bursts:
        parts.append(0.001 * rng.standard_normal(int(pause * SR)))
        parts.append(0.4 * rng.standard_normal(int(dur * SR)))
    parts.append(0.001 * rng.standard_normal(int(pause * SR)))
    return np.concatenate(parts).astype(np.float32)


def seeded_probs(samples, sample_rate):
    """A seeded frame classifier: 20 ms energy frames through a sigmoid,
    plus seeded noise (numpy only, so both packages see the same)."""
    n = int(sample_rate * 0.02)
    m = len(samples) // n
    db = 10 * np.log10(np.maximum(
        (samples[: m * n].astype(np.float64).reshape(m, n) ** 2).mean(1),
        1e-12))
    noise = np.random.default_rng(9).normal(0, 1.5, m)
    return (1 / (1 + np.exp(-(db + 30 + noise) / 3))).astype(np.float32)


# ------------------------------------------------- segmentation, realign
@pytest.mark.parametrize("aggressiveness,padding_ms",
                         [(1, 300), (3, 300), (0, 100)])
def test_pause_based_segments_match_jax(aggressiveness, padding_ms):
    from stac_st_tpu.prep import shas as jshas

    wav = conversation(seed=aggressiveness)
    got = shas.pause_based_segments(wav, SR, 10, aggressiveness, padding_ms)
    assert len(got) == 4
    assert got == jshas.pause_based_segments(wav, SR, 10, aggressiveness,
                                             padding_ms)
    # the choice rule: the real VAD where it imports, the energy one here
    assert type(shas.webrtc_vad_or_fallback(1)).__name__ in (
        "EnergyFrameVAD", "_Wrapped")


@pytest.mark.parametrize("lo,hi", [(0.3, 0.9), (2.0, 3.0), (0.1, 0.4)])
def test_shas_segments_match_jax(lo, hi):
    from stac_st_tpu.prep import shas as jshas

    wav = conversation(seed=4, bursts=(0.9, 1.6, 0.4, 2.2), pause=0.3)
    for prob_fn in (seeded_probs, None):
        got = shas.shas_segments(wav, SR, lo, hi, prob_fn)
        assert got and got == jshas.shas_segments(wav, SR, lo, hi, prob_fn)
    np.testing.assert_array_equal(shas.speech_probabilities(wav, SR),
                                  jshas.speech_probabilities(wav, SR))


def test_mwer_realignment_matches_jax():
    from stac_st_tpu.eval import long_form as jlf

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(12)]
    refs = [" ".join(rng.choice(words, n)) for n in (4, 7, 1, 5)]
    hyp = " ".join(" ".join(r.split()[1:] + list(rng.choice(words, 2)))
                   for r in refs)
    assert LF.realign_hypotheses(refs, hyp) == \
        jlf.realign_hypotheses(refs, hyp)
    split = [r.split() for r in refs]
    for hyp_words in (hyp.split(), [], hyp.split()[:3]):
        assert LF.mwer_segment(split, hyp_words) == \
            jlf.mwer_segment(split, hyp_words)
    assert LF.mwer_segment([], ["a"]) == []


# --------------------------------------------------------- the fronts
@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    from fixtures import make_corpus, train_fixture_tokenizer
    from stac_st_tpu_torch.ops.cmvn import cmvn_init
    from stac_st_tpu_torch.serving import STEngine

    root = str(tmp_path_factory.mktemp("torch_serving"))
    _, _, joint = make_corpus(root, n_utts=4, seconds=0.4)
    sp, _ = train_fixture_tokenizer(root, joint, vocab=150)
    jx = build_jax_tiny(seed=5)
    pt = build_port_twin(jx)
    # frequent [turn]/[xt] CTC winners, so the events are not empty
    with torch.no_grad():
        pt["ctc_lin"].linear.bias[sp.piece_to_id("[turn]")] += 2.0
        pt["ctc_lin"].linear.bias[sp.piece_to_id("[xt]")] += 1.9
    return STEngine(pt["transformer"], pt["cnn"], pt["seq_lin"],
                    pt["ctc_lin"], cmvn_init(80), sp, device="cpu",
                    bf16=False, beam_size=2, max_decode_tokens=6,
                    bucket_seconds=(0.5, 1.0), turn_id=sp.piece_to_id("[turn]"),
                    xt_id=sp.piece_to_id("[xt]"))


def _wavs(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(int(s * SR))).astype(np.float32)
            for s in seconds]


def test_front_end_equals_direct_calls_on_identical_batches(engine):
    """Requests queued before the worker starts coalesce into one batch:
    one engine call per (task, language pair), each on the same inputs as
    the direct call it is compared with."""
    wavs = _wavs(1, (0.3, 0.8, 0.45, 0.9))
    front = StreamingFrontEnd(engine, max_batch=16, max_wait_ms=50,
                              autostart=False)
    futs = {task: [front.submit(w, task) for w in wavs]
            for task in ("translate", "transcribe", "transcribe_translate",
                         "speaker_turns")}
    futs["es_es"] = [front.submit(w, "translate", "es", "es") for w in wavs]
    futs["long"] = [front.submit(conversation(), "long_form")]
    front.start()
    try:
        got = {k: [f.result(timeout=120) for f in v]
               for k, v in futs.items()}
    finally:
        front.close()
    assert got["translate"] == engine.translate(wavs)
    assert got["transcribe"] == engine.transcribe(wavs)
    assert got["es_es"] == engine.translate(wavs, "es", "es")
    asr, st = engine.transcribe_and_translate(wavs)
    assert got["transcribe_translate"] == [
        {"transcription": a, "translation": s} for a, s in zip(asr, st)]
    assert got["speaker_turns"] == engine.speaker_turns(wavs)
    assert got["long"] == [engine.long_form(conversation())]
    assert len(got["long"][0]["segments"]) == 4
    # 16 requests a batch: the four tasks, then es->es and long_form
    assert front.stats() == {"requests": 21, "batches": 2,
                             "engine_calls": 6, "max_batch_seen": 16}
    assert front.batch_histogram() == {16: 1, 5: 1}
    with pytest.raises(RuntimeError, match="closed"):
        front.submit(wavs[0])
    with pytest.raises(ValueError, match="task"):
        StreamingFrontEnd(engine, autostart=False).submit(wavs[0], "nope")


def test_turn_streamer_events_have_absolute_offsets(engine):
    wav = np.concatenate(_wavs(2, (0.7, 0.6, 0.5)))
    streamer = TurnStreamer(engine, window_seconds=0.5)
    events = []
    for a in range(0, len(wav), 3000):
        events += streamer.feed(wav[a:a + 3000])
    events += streamer.finish()
    assert streamer.finish() == []
    win = 8000
    cuts = list(range(0, len(wav), win))
    assert len(events) == len(cuts)
    for k, (a, ev) in enumerate(zip(cuts, events)):
        direct = engine.speaker_turns([wav[a:a + win]])[0]
        assert ev == {n: [a / SR + t for t in ts]
                      for n, ts in direct.items()}
    assert sum(len(e["turn"]) + len(e["xt"]) for e in events) > 0


def _post(port, path, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_routes_and_status_codes_batch_front(engine):
    wav = _wavs(3, (0.4,))[0]
    pcm = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    conv = conversation()
    server = STHttpServer(engine, port=0, max_batch=4, max_wait_ms=1)
    server.start()
    try:
        p = server.port
        assert _post(p, "/v1/translate", {"audio": wav.tolist()}) == \
            (200, {"text": engine.translate([wav])[0]})
        assert _post(p, "/v1/transcribe", {
            "audio_b64": base64.b64encode(wav.tobytes()).decode(),
            "source_lang": "es"}) == \
            (200, {"text": engine.transcribe([wav])[0]})
        asr, st = engine.transcribe_and_translate([pcm])
        assert _post(p, "/v1/transcribe_translate", {
            "audio_pcm16_b64": base64.b64encode(pcm.tobytes()).decode()}) == \
            (200, {"transcription": asr[0], "translation": st[0]})
        assert _post(p, "/v1/speaker_turns", {"audio": wav.tolist()}) == \
            (200, {"events": engine.speaker_turns([wav])[0]})
        code, lf = _post(p, "/v1/long_form", {"audio": conv.tolist()})
        assert code == 200 and lf == json.loads(json.dumps(
            engine.long_form(conv)))
        assert _get(p, "/healthz") == (200, {"status": "ok"})
        code, stats = _get(p, "/stats")
        assert code == 200 and stats["requests"] == 5
        assert _get(p, "/nope")[0] == 404
        assert _post(p, "/v1/nope", {"audio": [0.0]})[0] == 404
        assert _post(p, "/v1/translate", None, raw=b"{not json")[0] == 400
        assert _post(p, "/v1/translate", {"wav": [1.0]})[0] == 400
        assert _post(p, "/v1/translate", {"audio": []})[0] == 400
        assert _post(p, "/v1/translate", {"audio": [[0.1]]})[0] == 400
        server.front.close()  # a closed front answers 503
        assert _post(p, "/v1/translate", {"audio": wav.tolist()})[0] == 503
    finally:
        server.close()
    # an answer later than request_timeout is 504
    server = STHttpServer(engine, port=0, request_timeout=1e-4)
    server.start()
    try:
        assert _post(server.port, "/v1/translate",
                     {"audio": wav.tolist()})[0] == 504
    finally:
        server.close()


def test_http_routes_continuous_front(engine):
    wavs = _wavs(4, (0.3, 0.45, 0.4))
    cont = ContinuousBatchingEngine(engine, slots=2, chunk=3)
    server = STHttpServer(cont, port=0)
    server.start()
    try:
        p = server.port
        results = [None] * 3

        def client(i):
            results[i] = _post(p, "/v1/translate", {
                "audio_pcm16_b64": base64.b64encode(np.clip(
                    wavs[i] * 32768, -32768, 32767).astype(np.int16)
                    .tobytes()).decode()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(code == 200 and isinstance(r["text"], str)
                   for code, r in results)
        code, r = _post(p, "/v1/transcribe", {"audio": wavs[0].tolist()})
        assert code == 200 and isinstance(r["text"], str)
        for route in ("/v1/speaker_turns", "/v1/long_form",
                      "/v1/transcribe_translate"):
            assert _post(p, route, {"audio": wavs[0].tolist()})[0] == 400
        code, stats = _get(p, "/stats")
        assert code == 200 and stats["completed"] == 4
        assert 0 < stats["utilization"] <= 1
        assert _get(p, "/healthz") == (200, {"status": "ok"})
        cont.close()
        assert _post(p, "/v1/translate", {"audio": wavs[0].tolist()})[0] \
            == 503
    finally:
        server.close()
        cont.close()


# ------------------------------------------------------- the serve recipe
def test_serve_parser_refuses_what_the_port_cannot_serve():
    from stac_st_tpu_torch.recipes import serve

    p = serve.build_parser()
    for flags, name in ((["--transport", "grpc"], "--transport"),
                        (["--transport", "both"], "--transport"),
                        (["--grpc-port", "50051"], "--grpc-port")):
        with pytest.raises(ValueError, match=name):
            serve.start_servers(p.parse_args(["exp", *flags]))
    # more shards than visible cards (none here) exit naming the flag
    for n in ("2", "-1"):
        with pytest.raises(SystemExit, match="--data-parallel"):
            serve.start_servers(p.parse_args(["exp", "--data-parallel", n]))
    with pytest.raises(SystemExit):
        p.parse_args(["exp", "--compile-cache", "off"])
    args = p.parse_args(["exp"])
    assert args.device == "cuda" and args.transport == "http"
    assert serve._parse_pad_batch("4,16") == (4, 16)
    assert serve._parse_pad_batch("8") == 8


@pytest.fixture(scope="module")
def saved_experiment(tmp_path_factory):
    """A tiny experiment as training leaves one: the shipped YAML as its
    hyperparams.yaml, the tiny overrides, a tokenizer, one checkpoint of
    seeded weights with an ACC."""
    import shutil

    import yaml

    from fixtures import make_corpus
    from stac_st_tpu_torch.config import load_hyperpyyaml
    from stac_st_tpu_torch.interop.from_jax import to_jax_params
    from stac_st_tpu_torch.models import glorot_init_
    from stac_st_tpu_torch.tokenizer.train import SentencePiece
    from stac_st_tpu_torch.training.checkpoint import Checkpointer

    root = str(tmp_path_factory.mktemp("serve_exp"))
    _, _, joint = make_corpus(root, n_utts=8, seconds=0.5)
    tok = SentencePiece(
        model_dir=root, vocab_size=150, annotation_train=joint,
        annotation_read="transcription_and_translation", model_type="bpe",
        user_defined_symbols="[es],[en],[turn],[xt]", bos_id=1, eos_id=2,
        unk_id=0)
    exp = os.path.join(root, "exp")
    os.makedirs(exp)
    shutil.copy(os.path.join(ROOT, "recipes", "hparams",
                             "transformer_multitask.yaml"),
                os.path.join(exp, "hyperparams.yaml"))
    overrides = {"d_model": 32, "nhead": 4, "num_encoder_layers": 2,
                 "num_decoder_layers": 2, "d_ffn": 64, "output_neurons": 150,
                 "data_folder": root, "tokenizer_file": tok.model_path,
                 "output_folder": exp}
    with open(os.path.join(exp, "overrides.yaml"), "w") as f:
        yaml.safe_dump(overrides, f)
    with open(os.path.join(exp, "hyperparams.yaml")) as f:
        hp = load_hyperpyyaml(f, overrides)
    gen = torch.Generator().manual_seed(0)
    mods = [hp[k] for k in ("CNN", "Transformer", "seq_lin", "ctc_lin")]
    for m in mods:
        glorot_init_(m, gen)
    Checkpointer(os.path.join(exp, "save")).save_checkpoint(
        {"ACC": 0.5, "epoch": 1}, {"model": to_jax_params(*mods)})
    return exp


SERVE_TINY = ["--device", "cpu", "--no-bf16", "--buckets", "0.5",
              "--beam-size", "2", "--max-decode-tokens", "4",
              "--pad-batch", "1,2", "--slots", "2", "--chunk", "2",
              "--avg-checkpoints", "1", "--warmup-dual"]


@pytest.mark.parametrize("continuous,int8", [(False, False), (True, False),
                                             (True, True)])
def test_serve_recipe_starts_and_answers(saved_experiment, continuous, int8):
    """The batch front, and the slot loop finalized by the beam search
    (with ``--kv-cache-dtype int8 --weights-int8`` too, which reach the
    engine): either answers with the engine's own translate."""
    from stac_st_tpu_torch.recipes import serve

    int8_flags = ["--kv-cache-dtype", "int8", "--weights-int8"]
    args = serve.build_parser().parse_args(
        [saved_experiment, "--http-port", "0", *SERVE_TINY]
        + (["--continuous", "--protocol-finalize"] if continuous else [])
        + (int8_flags if int8 else []))
    front, server = serve.start_servers(args)
    try:
        assert front.engine.weights_int8 == int8
        assert front.engine.searcher.kv_cache_dtype == ("int8" if int8
                                                        else None)
        wav = _wavs(6, (0.4,))[0]
        code, r = _post(server.port, "/v1/translate",
                        {"audio": wav.tolist()})
        assert (code, r) == (200, {"text": front.engine.translate([wav])[0]})
        assert type(front).__name__ == (
            "ContinuousBatchingEngine" if continuous else "StreamingFrontEnd")
        assert front.engine.device.type == "cpu"
        if continuous:
            assert front.stats()["finalized"] == 1
    finally:
        server.close()
        front.close()


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sigterm_when_healthy(port):
    """A thread that waits for /healthz and for the entry point's own
    SIGTERM handler (installed after the server starts), then sends this
    process SIGTERM."""
    import signal
    import time

    before = signal.getsignal(signal.SIGTERM)

    def poke():
        for _ in range(600):
            try:
                if _get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.05)
        for _ in range(600):
            if signal.getsignal(signal.SIGTERM) is not before:
                break
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=poke, daemon=True)
    thread.start()
    return thread


@pytest.mark.parametrize("entry", ["recipe_main", "serve_forever"])
def test_entry_points_stop_on_sigterm(saved_experiment, engine, entry):
    """``recipes.serve.main`` and ``serving_http.serve_forever`` serve until
    SIGTERM, then close the server (the port is free again)."""
    import signal
    import socket

    from stac_st_tpu_torch.recipes import serve
    from stac_st_tpu_torch.serving_http import serve_forever

    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGTERM, signal.SIGINT)}
    port = _free_port()
    poke = _sigterm_when_healthy(port)
    try:
        if entry == "recipe_main":
            serve.main([saved_experiment, "--http-port", str(port),
                        "--no-warmup", "--log-level", "WARNING",
                        *SERVE_TINY])
        else:
            serve_forever(engine, port=port, max_batch=2)
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    poke.join(timeout=30)
    assert not poke.is_alive()
    with socket.socket() as sock:  # no listener left on the port
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", port))
        sock.listen()


# --------------------------------------------------- the kernel layer
def test_launch_counts_from_many_threads_are_exact():
    """count_launch is read-modify-write under a lock: 8 threads x 5000
    counts on 3 names, with the interpreter switching threads as often as
    it can, lose none."""
    kernels.reset_launches()
    barrier = threading.Barrier(8)

    def count():
        barrier.wait()
        for i in range(5000):
            kernels.count_launch(("a", "b", "c")[i % 3])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launches == {"a": 8 * 1667, "b": 8 * 1667,
                                "c": 8 * 1666}
    kernels.reset_launches()
    assert kernels.launches == {}


def test_library_is_built_and_loaded_once_across_threads(monkeypatch):
    """Threads that first touch a library together build and load it once
    (the build and the load run under one lock)."""
    import time

    calls = []

    def build(names):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return {}

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(kernels, "_libs", {})
    out = []
    threads = [threading.Thread(
        target=lambda: out.append(kernels.load_library("decode_attention")))
        for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(calls) == 1 and len(set(out)) == 1 and len(out) == 6
