"""STEngine: batched speech translation serving on one GPU.

Port of ``stac_st_tpu/serving.py::STEngine`` (the prompted beam-search
path). One call runs PCM16 or float audio through

    fbank -> CMVN -> conv front end -> encoder -> beam search
    (beam 10, eos threshold 1.5, length normalization, temperature 1.15,
    at most 192 decode tokens) -> detokenize,

and ``speaker_turns`` runs the CTC head's frame argmax into ``[turn]`` /
``[xt]`` events. Inputs are grouped into fixed audio-length buckets; ASR
and ST differ only in the decoder prompt, so ``transcribe_and_translate``
encodes once and searches both prompts in one fused search. ``long_form``
serves a whole conversation: VAD segments (``prep.shas``), then per bucket
one encoder pass feeding the dual-prompt search and the CTC events, merged
into conversation texts and absolute-time RTTM.

Weights are cast to bf16 when ``bf16`` is set; fbank, CMVN and beam
scoring stay fp32. ``weights_int8`` then quantizes the decode-path
weights (``utils.quantize``; their scales stay fp32), and
``kv_cache_dtype='int8'`` decodes with the int8 KV cache (the searcher's
gather mode at beam > 1); both are opt-in, since quantization noise can
reorder near-tied beams. The engine runs on ``cuda`` unless ``device="cpu"`` is
given, and owns the modules it is handed (it moves and casts them).
Setting ``searcher.mask_encoder_padding`` masks each input's bucket
padding in cross-attention, in the batch search (which is handed the
inputs' relative lengths) and in ``SpeculativeSTEngine`` (both models).

The tokenizer is duck-typed: ``encode_as_ids(text)`` and ``decode_ids``.
A trained experiment loads through ``from_saved_experiment(exp_dir)``
(modules rebuilt from the experiment's own ``hyperparams.yaml`` and
``overrides.yaml`` by the port's config loader) or ``from_experiment``
(dimensions given); both load the average of the ACC-top-k checkpoints
(written by either package) and the CMVN statistics saved beside them.
The serving front (``serving_stream``, ``serving_http``,
``serving_continuous``, ``recipes.serve``) drives this engine, and
``SpeculativeSTEngine`` pairs two engines for draft-and-verify greedy
decoding.

``mesh`` (a ``parallel.mesh.DataMesh``) serves data-parallel, as the JAX
engine over a mesh's ``data`` axis: the modules and CMVN are replicated
once per distinct device, each bucket's rows are padded to a multiple of
the shard count with full-length silence (dropped on output) and split
into one row block per shard, and each shard encodes and searches its
block in a host thread of its own, on its device and a CUDA stream of
its own (so a shard's host reads wait for its own work, also where two
shards share a card). The couplings across
rows stay those of the whole batch: the fbank ``top_db`` max is taken
over every shard's rows before any shard goes on, and the search's early
exit is exact (a row it settles decodes as under the full budget), so a
shard that settles before its batch mates gives the texts the whole
batch gives. Each shard launches the kernels a one-device engine launches
for its rows.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import yaml

from .data.audio import read_audio
from .decoding.beam_search import MultiTaskBeamSearch
from .decoding.speculative import bind_spec_model, speculative_greedy_search
from .device import model_dtype, resolve_device, set_tf32
from .interop.from_jax import load_jax_params
from .models import ConvolutionFrontEnd, LinearHead, TransformerMultiTask
from .ops import masks as M
from .ops.cmvn import CmvnState, cmvn_apply, cmvn_init
from .ops.fbank import Fbank
from .parallel.mesh import device_scope, row_blocks
from .tokenizer import SentencePieceProcessor
from .training.checkpoint import Checkpointer, average_checkpoints
from .utils.quantize import quantize_decode_weights
from .utils.rttm import extract_turn_events

__all__ = ["STEngine", "SpeculativeSTEngine"]

_BUCKET_SECONDS = (2.0, 4.0, 8.0, 16.0, 32.0)


class _Replica(NamedTuple):
    """The modules and CMVN statistics on one device of the mesh."""
    cnn: Any
    transformer: Any
    seq_lin: Any
    ctc_lin: Any
    cmvn: CmvnState


class STEngine:
    def __init__(self, transformer, cnn, seq_lin, ctc_lin, cmvn: CmvnState,
                 tokenizer, source_lang: str = "es", target_lang: str = "en",
                 beam_size: int = 10, max_decode_tokens: Optional[int] = 192,
                 sample_rate: int = 16000,
                 bucket_seconds: Sequence[float] = _BUCKET_SECONDS,
                 bf16: bool = True, pad_batch_rows=None,
                 transfer_dtype: str = "float32", turn_id: int = 7,
                 xt_id: int = 8, kv_cache_dtype: Optional[str] = None,
                 weights_int8: bool = False, device=None, mesh=None):
        """pad_batch_rows: None, an int (round rows up to a multiple) or a
        ladder of row counts (pad to the smallest rung that fits; beyond
        the top rung, round up to a multiple of it). Padded rows are
        full-length silence and are dropped on output. kv_cache_dtype:
        None or 'int8'; weights_int8: quantize the decode-path weights
        after the dtype cast. mesh: a ``DataMesh`` to serve over (its
        first device replaces ``device``)."""
        self.mesh = mesh
        if mesh is not None:
            for dev in mesh.distinct:
                resolve_device(dev)
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_tf32(False)
        self.tokenizer = tokenizer
        self.sample_rate = int(sample_rate)
        self.buckets = tuple(sorted(bucket_seconds))
        if pad_batch_rows and not isinstance(pad_batch_rows, int):
            self.pad_batch_rows = tuple(sorted(int(r) for r in pad_batch_rows))
            if min(self.pad_batch_rows) < 1:
                raise ValueError("pad_batch_rows ladder must be >= 1")
        else:
            self.pad_batch_rows = int(pad_batch_rows) if pad_batch_rows \
                else None
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(
                f"transfer_dtype must be float32|int16, got {transfer_dtype}")
        self.transfer_dtype = transfer_dtype
        self.source_lang, self.target_lang = source_lang, target_lang
        self.turn_id, self.xt_id = turn_id, xt_id
        self.dtype = model_dtype(bf16)

        self._fbank = Fbank(sample_rate=self.sample_rate)
        mods = [cnn, transformer, seq_lin] + (
            [ctc_lin] if ctc_lin is not None else [])
        for m in mods:
            m.to(device=self.device, dtype=self.dtype).eval()
        if weights_int8:
            quantize_decode_weights(transformer, seq_lin)
        self.weights_int8 = bool(weights_int8)
        self._cnn, self._transformer = cnn, transformer
        self._ctc_lin = ctc_lin
        self.cmvn = cmvn.to(self.device)
        self._replicas = {self.device: _Replica(cnn, transformer, seq_lin,
                                                ctc_lin, self.cmvn)}
        self._pool = None
        if mesh is not None:
            for dev in mesh.distinct:
                if dev not in self._replicas:
                    self._replicas[dev] = _Replica(*(
                        None if m is None else copy.deepcopy(m).to(dev)
                        for m in (cnn, transformer, seq_lin, ctc_lin)),
                        self.cmvn.to(dev))
            self._pool = ThreadPoolExecutor(len(mesh.devices),
                                            thread_name_prefix="shard")
            # a CUDA stream a shard: a shard's host reads wait for its own
            # work only, also where two shards share a card
            self._streams = [torch.cuda.Stream(device=d)
                             if d.type == "cuda" else None
                             for d in mesh.devices]
        self.searcher = MultiTaskBeamSearch(
            transformer, seq_lin, bos_index=1, eos_index=2, blank_index=0,
            min_decode_ratio=0.0, max_decode_ratio=1.0,
            beam_size=int(beam_size), using_eos_threshold=True,
            length_normalization=True, temperature=1.15,
            max_decode_tokens=max_decode_tokens,
            kv_cache_dtype=kv_cache_dtype,
        )

    # ------------------------------------------------------------ factories
    @classmethod
    def from_experiment(
        cls, pretrained_path: str, tokenizer_file: str,
        d_model: int = 256, nhead: int = 4, num_encoder_layers: int = 12,
        num_decoder_layers: int = 6, d_ffn: int = 1024, vocab: int = 5000,
        **kw,
    ) -> "STEngine":
        """Load averaged weights from a training experiment's save dir
        into the canonical YAML's modules (front end of two 256-channel
        blocks over 80 mels, pre-LN transformer) at the dimensions given;
        ``from_saved_experiment`` reads every setting from the
        experiment's own config instead."""
        tokenizer = SentencePieceProcessor(tokenizer_file)
        cnn = ConvolutionFrontEnd()
        transformer = TransformerMultiTask(
            tgt_vocab=vocab, input_size=5120, d_model=d_model, nhead=nhead,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, d_ffn=d_ffn,
            dropout=0.1, normalize_before=True)
        seq_lin = LinearHead(input_size=d_model, n_neurons=vocab)
        ctc_lin = LinearHead(input_size=d_model, n_neurons=vocab)
        return cls._load_from_save(
            cnn, transformer, seq_lin, ctc_lin,
            os.path.join(pretrained_path, "save"), tokenizer, 80, **kw)

    @classmethod
    def from_saved_experiment(
        cls, experiment_directory: str,
        tokenizer_file: Optional[str] = None, **kw,
    ) -> "STEngine":
        """Reload a training experiment from its OWN saved config: the
        modules are rebuilt from ``hyperparams.yaml`` + ``overrides.yaml``
        through the port's config loader exactly as training built them,
        so the caller never re-specifies model dimensions."""
        from .config.hyperyaml import load_hyperpyyaml

        ov_path = os.path.join(experiment_directory, "overrides.yaml")
        overrides = {}
        if os.path.isfile(ov_path):
            with open(ov_path) as f:
                overrides = yaml.safe_load(f) or {}
        with open(os.path.join(experiment_directory,
                               "hyperparams.yaml")) as f:
            hp = load_hyperpyyaml(f, overrides)

        tokenizer_file = tokenizer_file or hp.get("tokenizer_file")
        if not tokenizer_file or not os.path.isfile(str(tokenizer_file)):
            raise FileNotFoundError(
                "tokenizer model not found; pass tokenizer_file= (saved "
                f"config points at {tokenizer_file!r})")
        tokenizer = SentencePieceProcessor(str(tokenizer_file))
        return cls._load_from_save(
            hp["CNN"], hp["Transformer"], hp["seq_lin"], hp.get("ctc_lin"),
            os.path.join(experiment_directory, "save"), tokenizer,
            int(hp.get("n_mels", 80)), **kw)

    @classmethod
    def _load_from_save(cls, cnn, transformer, seq_lin, ctc_lin,
                        ckpt_dir: str, tokenizer, n_mels: int,
                        avg_checkpoints: Optional[int] = None,
                        **kw) -> "STEngine":
        """``avg_checkpoints``: average the top N by ACC (None: all
        kept)."""
        ckpts = Checkpointer(ckpt_dir).find_checkpoints(
            max_key="ACC", max_num_checkpoints=avg_checkpoints)
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        raw = average_checkpoints(ckpts, "model")
        if ctc_lin is None:
            raw.pop("ctc_lin", None)
        load_jax_params(raw, cnn=cnn, transformer=transformer,
                        seq_lin=seq_lin, ctc_lin=ctc_lin,
                        settings=transformer)
        cmvn = cmvn_init(n_mels)
        if "normalizer" in ckpts[0].names():
            n = ckpts[0].load("normalizer")
            cmvn = CmvnState(*(torch.from_numpy(np.array(n[k], np.float32))
                               for k in ("mean", "std", "count")))
        return cls(transformer, cnn, seq_lin, ctc_lin, cmvn, tokenizer, **kw)

    # ------------------------------------------------------------- internal
    def _bucket_width(self, n_samples: int) -> int:
        seconds = n_samples / self.sample_rate
        for b in self.buckets:
            if seconds <= b:
                return int(b * self.sample_rate)
        return int(math.ceil(seconds / self.buckets[-1]) * self.buckets[-1]
                   * self.sample_rate)

    def _rows(self, n: int) -> int:
        if isinstance(self.pad_batch_rows, tuple):
            top = self.pad_batch_rows[-1]
            if n > top:
                return n + (-n) % top
            return next(r for r in self.pad_batch_rows if r >= n)
        if self.pad_batch_rows:
            return n + (-n) % self.pad_batch_rows
        return n

    def _prepare(self, wavs: Sequence[np.ndarray]):
        """Group inputs by bucket: [(indices, (rows, width) audio on the
        device, (rows,) relative lengths)], buckets in increasing width."""
        pcm16 = self.transfer_dtype == "int16"
        by_width: Dict[int, List[int]] = {}
        arrays = []
        for i, wav in enumerate(wavs):
            wav = np.asarray(wav)
            if pcm16:
                if wav.dtype != np.int16:
                    wav = np.clip(np.asarray(wav, np.float32) * 32768.0,
                                  -32768, 32767).astype(np.int16)
            elif wav.dtype == np.int16:
                wav = wav.astype(np.float32) / 32768.0
            else:
                wav = np.asarray(wav, np.float32)
            arrays.append(wav)
            by_width.setdefault(self._bucket_width(len(wav)), []).append(i)
        groups = []
        dev = self.device if self.mesh is None else "cpu"  # sharded later
        for width, idx in sorted(by_width.items()):
            rows = self._rows(len(idx))
            if self.mesh is not None:
                rows += (-rows) % len(self.mesh.devices)
            batch = np.zeros((rows, width), np.int16 if pcm16 else np.float32)
            # padded rows are full-length silence (length 1.0): a zero
            # length would make every encoder position padding
            lens = np.ones((rows,), np.float32)
            for row, i in enumerate(idx):
                batch[row, : len(arrays[i])] = arrays[i]
                lens[row] = len(arrays[i]) / width
            groups.append((idx, torch.from_numpy(batch).to(dev),
                           torch.from_numpy(lens).to(dev)))
        return groups

    def _encode(self, wavs: torch.Tensor, wav_lens: torch.Tensor,
                rep: Optional[_Replica] = None):
        """The encoder output of a batch, by ``rep``'s modules (default:
        the engine's, on ``self.device``)."""
        rep = rep or self._replicas[self.device]
        if wavs.dtype == torch.int16:  # PCM16 transfer: unpack on device
            wavs = wavs.to(torch.float32) / 32768.0
        feats = cmvn_apply(rep.cmvn, self._fbank(wavs)).to(self.dtype)
        return rep.transformer.encode(rep.cnn(feats), wav_lens)

    def _searcher_for(self, rep: _Replica) -> MultiTaskBeamSearch:
        """The engine's searcher (its settings as they are now) over one
        replica's modules."""
        s = copy.copy(self.searcher)
        s.model, s.seq_lin, s.ctc_lin = rep.transformer, rep.seq_lin, \
            rep.ctc_lin
        return s

    def _sharded(self, batch: torch.Tensor, lens: torch.Tensor,
                 work: Callable) -> List[Any]:
        """Run ``work(replica, searcher, enc, lens)`` on each shard's row
        block of a bucket batch (host tensors), one host thread per shard;
        returns the shards' results in shard order. The fbank dB of every
        block is computed first, and the ``top_db`` clamp takes the max
        over all of them, as over the whole batch."""
        devs = self.mesh.devices
        blocks = []
        for (lo, hi), dev in zip(row_blocks(batch.shape[0], len(devs)),
                                 devs):
            with device_scope(dev):
                w = batch[lo:hi].to(dev)
                if w.dtype == torch.int16:
                    w = w.to(torch.float32) / 32768.0
                blocks.append((self._fbank.db(w), lens[lo:hi].to(dev)))
        top = torch.stack([x.max().to(self.device) for x, _ in blocks]).max()
        tops = [top.to(dev) for dev in devs]

        def run(k: int):
            dev, stream = devs[k], self._streams[k]
            rep = self._replicas[dev]
            with device_scope(dev), torch.inference_mode(), (
                    contextlib.nullcontext() if stream is None
                    else torch.cuda.stream(stream)):
                if stream is not None:  # the blocks came on the default one
                    stream.wait_stream(torch.cuda.default_stream(dev))
                x_db, wl = blocks[k]
                feats = cmvn_apply(rep.cmvn, self._fbank.clamp(
                    x_db, tops[k])).to(self.dtype)
                enc = rep.transformer.encode(rep.cnn(feats), wl)
                return work(rep, self._searcher_for(rep), enc, wl)

        return list(self._pool.map(run, range(len(devs))))

    def _prompt(self, src: str, tgt: str) -> List[int]:
        sp = self.tokenizer
        return [self.searcher.bos_token, sp.encode_as_ids(f"[{src}]")[-1],
                sp.encode_as_ids(f"[{tgt}]")[-1]]

    def _ctc_frames(self, enc: torch.Tensor, lens: torch.Tensor,
                    ctc_lin=None) -> np.ndarray:
        """The CTC head's frame argmax (rows, frames) on the host; frames
        past each input's ceil(len · frames) are forced to blank, so bucket
        padding cannot fake speaker-change spikes."""
        head = self._ctc_lin if ctc_lin is None else ctc_lin
        am = torch.argmax(head(enc), dim=-1)
        n_frames = enc.shape[1]
        valid = torch.ceil(lens * n_frames).to(torch.long)
        frames = torch.arange(n_frames, device=am.device)
        am = torch.where(frames[None, :] < valid[:, None], am,
                         self.searcher.config.blank_index)
        return am.cpu().numpy()

    @torch.inference_mode()
    def _texts(self, wavs, prompts: List[List[int]],
               rttm_ids: Optional[List[str]] = None):
        """texts[p][i]: input i decoded under prompt p. Per bucket, one
        encoder pass and ONE search over all prompts (the encoder output
        tiled once per prompt). With ``rttm_ids`` (one utterance id per
        input) the same encoder pass also feeds the CTC head, and its
        [turn]/[xt] RTTM lines come back as well. Returns (texts, rttm or
        None)."""
        out = [[""] * len(wavs) for _ in prompts]
        rttm = None
        if rttm_ids is not None and self._ctc_lin is not None:
            rttm = {"turn": [], "xt": []}
        want_ctc = rttm is not None

        def work(rep, searcher, enc, lens):
            frames = self._ctc_frames(enc, lens, rep.ctc_lin) \
                if want_ctc else None
            return ([hyps for hyps, _ in searcher.call_multi(
                enc, lens, prompts=prompts)], frames)

        for idx, batch, lens in self._prepare(wavs):
            if self.mesh is None:
                hyps, frames = work(self._replicas[self.device],
                                    self.searcher,
                                    self._encode(batch, lens), lens)
            else:
                shards = self._sharded(batch, lens, work)
                hyps = [sum((h[p] for h, _ in shards), [])
                        for p in range(len(prompts))]
                frames = np.concatenate([f for _, f in shards]) \
                    if want_ctc else None
            if want_ctc:
                events = extract_turn_events(
                    [rttm_ids[i] for i in idx], frames[: len(idx)],
                    {"turn": self.turn_id, "xt": self.xt_id})
                for name in rttm:
                    rttm[name].extend(events[name])
            for p in range(len(prompts)):
                for row, i in enumerate(idx):
                    out[p][i] = self.tokenizer.decode_ids(hyps[p][row])
        return out, rttm

    # ------------------------------------------------------------------ API
    def load_audio(self, path: str) -> np.ndarray:
        return read_audio(path, sample_rate=self.sample_rate)[0]

    def warmup(self, dual: bool = False) -> int:
        """Serve silence once at every (bucket, pad rung) shape, so a fresh
        server pays its first-call costs (cuBLAS and cuDNN set-up, the
        kernels' first launch) before traffic; ``dual`` also serves
        ``transcribe_and_translate`` at each. Returns the number of shapes
        served."""
        rungs = (self.pad_batch_rows
                 if isinstance(self.pad_batch_rows, tuple)
                 else (self.pad_batch_rows or 1,))
        n = 0
        for sec in self.buckets:
            wav = np.zeros((max(int(sec * self.sample_rate), 1),),
                           np.float32)
            for r in rungs:
                self.translate([wav] * int(r))
                if dual:
                    self.transcribe_and_translate([wav] * int(r))
                n += 1
        return n

    def translate(self, wavs: Sequence[np.ndarray],
                  source_lang: Optional[str] = None,
                  target_lang: Optional[str] = None) -> List[str]:
        src = source_lang or self.source_lang
        return self._texts(wavs, [self._prompt(
            src, target_lang or self.target_lang)])[0][0]

    def transcribe(self, wavs: Sequence[np.ndarray],
                   source_lang: Optional[str] = None) -> List[str]:
        lang = source_lang or self.source_lang
        return self._texts(wavs, [self._prompt(lang, lang)])[0][0]

    def transcribe_and_translate(
        self, wavs: Sequence[np.ndarray], source_lang: Optional[str] = None,
        target_lang: Optional[str] = None,
    ) -> Tuple[List[str], List[str]]:
        """Both task outputs from ONE encoder pass and ONE fused
        dual-prompt search (2 rows per utterance). Returns
        (transcriptions, translations)."""
        src = source_lang or self.source_lang
        tgt = target_lang or self.target_lang
        (asr, st), _ = self._texts(
            wavs, [self._prompt(src, src), self._prompt(src, tgt)])
        return asr, st

    @torch.inference_mode()
    def speaker_turns(self, wavs: Sequence[np.ndarray]) -> List[Dict]:
        """Per-input [turn]/[xt] event times (seconds) from the CTC head.
        Frames past each input's length are forced to blank, so bucket
        padding cannot fake speaker-change spikes."""
        if self._ctc_lin is None:
            raise RuntimeError("engine built without a CTC head")
        results: List[Optional[Dict]] = [None] * len(wavs)
        for idx, batch, lens in self._prepare(wavs):
            if self.mesh is None:
                frames = self._ctc_frames(self._encode(batch, lens), lens)
            else:
                frames = np.concatenate(self._sharded(
                    batch, lens, lambda rep, _s, enc, wl:
                    self._ctc_frames(enc, wl, rep.ctc_lin)))
            ids = [f"utt{i}-0-0-0" for i in idx]
            events = extract_turn_events(
                ids, frames[: len(idx)],
                {"turn": self.turn_id, "xt": self.xt_id})
            for row, i in enumerate(idx):
                results[i] = {
                    name: [float(line.split()[3]) for line in events[name]
                           if line.split()[1] == ids[row]]
                    for name in ("turn", "xt")
                }
        return results  # type: ignore[return-value]

    def long_form(
        self,
        wav: np.ndarray,
        source_lang: Optional[str] = None,
        target_lang: Optional[str] = None,
        *,
        segmentation: str = "pause",
        dac_min_segment_length: float = 10.0,
        dac_max_segment_length: float = 15.0,
        frame_ms: int = 10,
        aggressiveness: int = 1,
        padding_ms: int = 300,
        prob_fn: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
        uri: str = "conversation",
    ) -> Dict:
        """A whole conversation in one call: segment the waveform
        (``segmentation='pause'``: the pause-based VAD at frame 10 ms,
        aggressiveness 1; ``'shas'``: pDAC at min/max 10/15 s, over
        ``prob_fn``'s frame probabilities when given), then per bucket one
        encoder pass feeding the dual-prompt (ASR + ST) search and the CTC
        [turn]/[xt] events, merged.

        Returns ``segments`` (start / end seconds, raw ``transcription`` and
        ``translation`` with their markers), the conversation's merged
        texts without markers, and absolute-time RTTM lines per marker,
        sorted by time (utterance ids ``<uri>-0-<start_cs>-<end_cs>``, the
        reference's centisecond convention)."""
        from .prep.shas import pause_based_segments, shas_segments

        wav = np.asarray(wav)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        else:
            wav = wav.astype(np.float32)
        if segmentation == "pause":
            segs = pause_based_segments(
                wav, self.sample_rate, frame_ms, aggressiveness, padding_ms)
        elif segmentation == "shas":
            segs = shas_segments(
                wav, self.sample_rate, dac_min_segment_length,
                dac_max_segment_length, prob_fn)
        else:
            raise ValueError(f"segmentation must be 'pause' or 'shas', got "
                             f"{segmentation!r}")
        if not segs:
            return {"segments": [], "transcription": "", "translation": "",
                    "rttm": {"turn": [], "xt": []}}
        segs = sorted(segs)
        sr = self.sample_rate
        seg_wavs, seg_ids = [], []
        for off, dur in segs:
            a, b = int(round(off * sr)), int(round((off + dur) * sr))
            seg_wavs.append(wav[a:b])
            seg_ids.append(f"{uri}-0-{int(round(off * 100)):06d}-"
                           f"{int(round((off + dur) * 100)):06d}")
        src = source_lang or self.source_lang
        tgt = target_lang or self.target_lang
        (asr, st), rttm = self._texts(
            seg_wavs, [self._prompt(src, src), self._prompt(src, tgt)],
            rttm_ids=seg_ids)
        rttm = rttm or {"turn": [], "xt": []}
        for name in rttm:
            rttm[name].sort(key=lambda ln: float(ln.split()[3]))

        def clean(texts: List[str]) -> str:
            words = " ".join(t for t in texts if t).split()
            return " ".join(w for w in words if w not in ("[turn]", "[xt]"))

        return {
            "segments": [
                {"start": round(off, 6), "end": round(off + dur, 6),
                 "transcription": asr[i], "translation": st[i]}
                for i, (off, dur) in enumerate(segs)
            ],
            "transcription": clean(asr),
            "translation": clean(st),
            "rttm": rttm,
        }


class SpeculativeSTEngine:
    """Single-stream speculative serving: a draft engine proposes ``k``
    tokens a round and the target engine verifies them in one windowed
    decode step. The output is the target's greedy decode (beam 1),
    token for token, whatever the draft proposes; the draft changes only
    how many target steps it takes. Port of the reference's
    ``SpeculativeSTEngine``.

    The two ``STEngine``s share a tokenizer and a sample rate, and each
    may use int8 weights and the int8 cache. Each utterance is encoded
    by both engines' own encoders at the target's bucket width and
    decoded alone (``decoding.speculative``); ``last_stats`` holds, per
    utterance of the last call, its tokens, target steps, tokens per
    target step and drafted tokens.
    """

    def __init__(self, target: STEngine, draft: STEngine, k: int = 6):
        if target.sample_rate != draft.sample_rate:
            raise ValueError("target/draft sample rates differ")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.target, self.draft, self.k = target, draft, int(k)
        self.last_stats: List[Dict] = []
        self._bound = [bind_spec_model(e._transformer, e.searcher.seq_lin,
                                       e.searcher.kv_cache_dtype)
                       for e in (target, draft)]

    @torch.inference_mode()
    def _decode_one(self, wav: np.ndarray, src: str, tgt: str) -> str:
        target, draft = self.target, self.draft
        wav = np.asarray(wav)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        width = target._bucket_width(len(wav))
        batch = np.zeros((1, width), np.float32)
        batch[0, : len(wav)] = wav
        lens = np.asarray([len(wav) / width], np.float32)
        enc = [e._encode(torch.from_numpy(batch).to(e.device),
                         torch.from_numpy(lens).to(e.device))
               for e in (target, draft)]
        S = enc[0].shape[1]
        cap = target.searcher.max_decode_tokens
        max_steps = S if cap is None else min(S, cap)
        prompt = torch.tensor(target._prompt(src, tgt))
        # the target's searcher decides whether both models mask padding
        biases = [None, None]
        if target.searcher.mask_encoder_padding:
            biases = [M.additive_bias(M.src_key_padding_mask_encode(
                torch.from_numpy(lens).to(e.device), x.shape[1]))
                for e, x in zip((target, draft), enc)]
        res = speculative_greedy_search(
            *self._bound, *enc, prompt, max_steps, self.k,
            eos_index=target.searcher.config.eos_index,
            enc_bias_target=biases[0], enc_bias_draft=biases[1])
        n = res.length
        self.last_stats.append({
            "tokens": n, "target_steps": res.target_steps,
            "tokens_per_target_step": n / max(res.target_steps, 1),
            "drafted": res.drafted})
        return target.tokenizer.decode_ids(res.tokens[:n].tolist())

    # ------------------------------------------------------------------ API
    def transcribe(self, wavs: Sequence[np.ndarray],
                   source_lang: Optional[str] = None) -> List[str]:
        lang = source_lang or self.target.source_lang
        self.last_stats = []
        return [self._decode_one(w, lang, lang) for w in wavs]

    def translate(self, wavs: Sequence[np.ndarray],
                  source_lang: Optional[str] = None,
                  target_lang: Optional[str] = None) -> List[str]:
        src = source_lang or self.target.source_lang
        tgt = target_lang or self.target.target_lang
        self.last_stats = []
        return [self._decode_one(w, src, tgt) for w in wavs]

    def warmup(self) -> int:
        """Serve silence once at every target bucket. Returns the number
        of buckets served."""
        for sec in self.target.buckets:
            self.translate([np.zeros((max(int(sec * self.target.sample_rate),
                                          1),), np.float32)])
        return len(self.target.buckets)
