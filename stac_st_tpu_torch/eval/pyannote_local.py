"""First-party local backend for the pyannote speaker-change baseline.

A port of ``stac_st_tpu/eval/pyannote_local.py``. :class:`MiniPyanNet` is
an ``nn.Module`` on an explicit device (``cuda`` unless the caller passes
``device="cpu"``); its ``state_dict`` keys are the JAX package's, so a
checkpoint that either package's ``build_local_segmentation_checkpoint``
writes loads in the other's :func:`load_local_model`. One deliberate
difference: the JAX package's modules take their default (non-Glorot)
initialisation from torch's process-wide generator, while the port seeds
that generator with ``seed`` for the construction (under
``torch.random.fork_rng``), so the port's model is a function of its
seed alone and equals the JAX package's built after
``torch.manual_seed(seed)``. Inference runs the windows on the
model's device; everything after the posteriors is numpy, as in the JAX
package.

``pyannote.audio`` needs both the wheel and an HF-hosted
``pyannote/segmentation`` checkpoint behind an auth token. This module
makes the baseline *executable without them* by re-owning the exact
objects the reference model path consumes (the reference's
``evaluations/pyannote/eval_pyannote.py:91-132``):

* :class:`MiniPyanNet` — a real torch model with the PyanNet architecture
  (SincNet band-pass front end -> BiLSTM -> linear -> per-speaker sigmoid),
  miniaturized the same way the Whisper baseline's locally built tiny
  checkpoint is.
* :class:`LocalInference` — pyannote's sliding-window inference semantics:
  fixed-duration chunks, ``pre_aggregation_hook`` on raw chunk outputs,
  Hamming-weighted overlap-add aggregation onto a global frame track.
* :class:`Binarize` / :class:`Peak` — the ``pyannote.audio.utils.signal``
  semantics the reference uses: onset/offset hysteresis VAD regions, and
  local-maxima peak partitioning with ``alpha`` height and ``min_duration``
  spacing, plus ``Timeline.crop`` intersection.
* :class:`LocalDiarizationPipeline` — the ``speaker-diarization@2.1``
  pipeline semantics (the reference's ``evaluations/pyannote/
  eval_pyannote.py:65-89``): sliding-window segmentation, per-chunk local
  speaker embeddings, constrained agglomerative clustering, cluster-wise
  activation aggregation into final speaker turns.

This is NOT pyannote and carries no pretrained weights; it exists so the
baseline's model path (sliding windows, aggregation, VAD+SCD math, RTTM
emission) runs without ``pyannote.audio`` and its gated checkpoints. Where
the real package is installed, the baseline uses it (``backend="pyannote"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from math import gcd
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.audio import read_audio
from ..data.resample import fast_resample_poly
from ..device import resolve_device

__all__ = [
    "Segment",
    "Timeline",
    "SlidingWindowFeature",
    "MiniPyanNet",
    "LocalInference",
    "Binarize",
    "Peak",
    "build_local_segmentation_checkpoint",
    "load_local_model",
    "Annotation",
    "LocalDiarizationPipeline",
    "agglomerative_cluster",
    "spectral_embedding",
]


# ---------------------------------------------------------------------------
# pyannote.core-shaped containers (the minimal surface the baseline touches)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    start: float
    end: float

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def __and__(self, other: "Segment") -> Optional["Segment"]:
        s, e = max(self.start, other.start), min(self.end, other.end)
        return Segment(s, e) if e > s else None


class Timeline:
    """Ordered list of segments with the two methods the baseline uses."""

    def __init__(self, segments: Sequence[Segment] = ()):
        self.segments: List[Segment] = sorted(
            (s for s in segments if s.duration > 0.0),
            key=lambda s: (s.start, s.end),
        )

    def __iter__(self):
        return iter(self.segments)

    def __len__(self):
        return len(self.segments)

    def get_timeline(self) -> "Timeline":
        return self

    def crop(self, support: "Timeline") -> "Timeline":
        """Intersection crop (pyannote ``Timeline.crop(mode='intersection')``)."""
        out: List[Segment] = []
        for seg in self.segments:
            for sup in support:
                inter = seg & sup
                if inter is not None:
                    out.append(inter)
        return Timeline(out)


@dataclass
class SlidingWindowFrames:
    start: float
    duration: float
    step: float


class SlidingWindowFeature:
    """(num_frames, dim) track + its frame clock."""

    def __init__(self, data: np.ndarray, frames: SlidingWindowFrames):
        self.data = np.asarray(data)
        self.sliding_window = frames

    def frame_time(self, i: int) -> float:
        """Center time of frame ``i`` (pyannote indexes frame centers)."""
        f = self.sliding_window
        return f.start + i * f.step + 0.5 * f.duration


# ---------------------------------------------------------------------------
# The model: PyanNet architecture, miniaturized
# ---------------------------------------------------------------------------


def _mel_init_bands(n_filters: int, sample_rate: int):
    """SincNet's mel-spaced initial band edges (low_hz, band_hz)."""
    low_hz, high_hz = 30.0, sample_rate / 2.0 - 100.0

    def to_mel(hz):
        return 2595.0 * math.log10(1.0 + hz / 700.0)

    def to_hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    mel = np.linspace(to_mel(low_hz), to_mel(high_hz), n_filters + 1)
    hz = to_hz(mel)
    return hz[:-1], np.diff(hz)


class MiniPyanNet(nn.Module):
    """PyanNet (SincNet -> BiLSTM -> linear -> sigmoid), miniaturized.

    Architecture mirrors pyannote/segmentation: a learnable band-pass sinc
    convolution (stride 10) with abs + max-pool 3x stacked conv blocks
    (total frame stride 270 samples ~= 16.9 ms), a bidirectional LSTM,
    two linear+LeakyReLU layers, and a per-speaker sigmoid classifier.
    The modules are made on the CPU, in the JAX package's order, and then
    moved to ``device``.
    """

    SAMPLE_RATE = 16000
    STRIDE = 270  # 10 * 3 * 3 * 3
    KERNEL = 251

    def __init__(self, n_filters=16, conv_channels=16, lstm_hidden=32,
                 linear_dim=32, n_speakers=3, duration=5.0, seed=0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.duration = float(duration)
        self.n_speakers = n_speakers
        self._hparams = dict(
            n_filters=n_filters, conv_channels=conv_channels,
            lstm_hidden=lstm_hidden, linear_dim=linear_dim,
            n_speakers=n_speakers, duration=duration,
        )
        g = torch.Generator().manual_seed(seed)

        def _init(m):
            for p in m.parameters():
                if p.dim() > 1:
                    nn.init.xavier_uniform_(p, generator=g)
            return m

        low, band = _mel_init_bands(n_filters, self.SAMPLE_RATE)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.low_hz = nn.Parameter(
                torch.tensor(low / self.SAMPLE_RATE, dtype=torch.float32))
            self.band_hz = nn.Parameter(
                torch.tensor(band / self.SAMPLE_RATE, dtype=torch.float32))
            self.conv1 = _init(nn.Conv1d(n_filters, conv_channels, 5))
            self.conv2 = _init(nn.Conv1d(conv_channels, conv_channels, 5))
            self.norm0 = nn.InstanceNorm1d(n_filters)
            self.norm1 = nn.InstanceNorm1d(conv_channels)
            self.norm2 = nn.InstanceNorm1d(conv_channels)
            self.lstm = _init(nn.LSTM(conv_channels, lstm_hidden,
                                      num_layers=1, bidirectional=True,
                                      batch_first=True))
            self.lin1 = _init(nn.Linear(2 * lstm_hidden, linear_dim))
            self.lin2 = _init(nn.Linear(linear_dim, linear_dim))
            self.head = _init(nn.Linear(linear_dim, n_speakers))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.low_hz.device

    def _sinc_filters(self):
        """Band-pass filter bank from the learnable band edges."""
        low = 30.0 / self.SAMPLE_RATE + torch.abs(self.low_hz)
        high = torch.clamp(low + torch.abs(self.band_hz), max=0.5)
        n = (self.KERNEL - 1) // 2
        t = torch.arange(-n, n + 1, dtype=torch.float32,
                         device=self.device)  # (K,)

        # safe denominator: torch.where back-propagates NaN from the
        # unselected 0/0 branch, so never actually divide by t == 0
        t_safe = torch.where(t == 0, torch.ones_like(t), t)

        def sinc(f):
            # f: (F, 1) cycles/sample; sin(2 pi f t) / (pi t), t=0 -> 2f
            x = 2 * math.pi * f * t[None, :]
            y = torch.where(
                t[None, :] == 0,
                2 * f.expand(-1, t.numel()),
                torch.sin(x) / (math.pi * t_safe[None, :]),
            )
            return y

        band_pass = sinc(high[:, None]) - sinc(low[:, None])
        window = torch.hamming_window(self.KERNEL, device=self.device)
        return (band_pass * window[None, :])[:, None, :]  # (F, 1, K)

    def forward(self, waveforms):
        """(batch, 1, samples) -> (batch, frames, n_speakers) sigmoid."""
        F = nn.functional
        x = waveforms
        x = F.instance_norm(x)
        x = F.conv1d(x, self._sinc_filters(), stride=10)
        x = F.max_pool1d(torch.abs(x), 3, stride=3)
        x = self.norm0(x)
        x = F.max_pool1d(F.leaky_relu(self.conv1(x)), 3, stride=3)
        x = self.norm1(x)
        x = F.max_pool1d(F.leaky_relu(self.conv2(x)), 3, stride=3)
        x = self.norm2(x)
        x, _ = self.lstm(x.transpose(1, 2))
        x = F.leaky_relu(self.lin1(x))
        x = F.leaky_relu(self.lin2(x))
        return torch.sigmoid(self.head(x))

    def num_frames(self, n_samples: int) -> int:
        with torch.no_grad():
            out = self(torch.zeros(1, 1, n_samples, device=self.device))
        return out.shape[1]


def build_local_segmentation_checkpoint(path: str, seed: int = 0,
                                        train_steps: int = 150,
                                        n_speakers: int = 3,
                                        device=None) -> str:
    """Build a miniature segmentation checkpoint locally (the Whisper-
    baseline trick): brief supervised training on synthetic two-speaker
    audio so VAD and speaker posteriors are meaningful, then torch.save.

    Speaker 0 "speaks" as band-limited noise around 500 Hz, speaker 1
    around 3 kHz; silence is near-zero. 150 Adam steps on a ~20k-param
    model takes seconds on CPU. The batches are drawn with numpy on the
    host and the steps run on ``device``; the checkpoint holds CPU tensors.
    """
    model = MiniPyanNet(n_speakers=n_speakers, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    sr = model.SAMPLE_RATE
    n = int(model.duration * sr)
    frames = model.num_frames(n)

    def synth_batch(b=4):
        wavs = np.zeros((b, 1, n), np.float32)
        labels = np.zeros((b, frames, n_speakers), np.float32)
        for i in range(b):
            t = 0
            while t < n:
                seg = int(rng.uniform(0.4, 1.2) * sr)
                seg = min(seg, n - t)
                kind = rng.integers(0, 3)  # 0: silence, 1: spk0, 2: spk1
                if kind > 0:
                    carrier = 500.0 if kind == 1 else 3000.0
                    tt = np.arange(seg) / sr
                    tone = np.sin(2 * np.pi * carrier * tt)
                    noise = rng.standard_normal(seg) * 0.1
                    wavs[i, 0, t:t + seg] = 0.5 * tone + noise
                    f0 = int(t / n * frames)
                    f1 = int((t + seg) / n * frames)
                    labels[i, f0:f1, kind - 1] = 1.0
                t += seg
        return (torch.tensor(wavs, device=model.device),
                torch.tensor(labels, device=model.device))

    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=1e-3)
    for _ in range(train_steps):
        wavs, labels = synth_batch()
        out = model(wavs).clamp(1e-6, 1 - 1e-6)
        loss = torch.nn.functional.binary_cross_entropy(out, labels)
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()

    torch.save({"hparams": model._hparams,
                "state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()},
                "final_loss": float(loss.detach())}, path)
    return path


def load_local_model(path: str, device=None) -> MiniPyanNet:
    """A checkpoint either package's build wrote, on ``device``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = MiniPyanNet(**ckpt["hparams"], device=device)
    model.load_state_dict(ckpt["state_dict"])
    return model


# ---------------------------------------------------------------------------
# Inference: sliding windows + hook + Hamming overlap-add (pyannote 2.x)
# ---------------------------------------------------------------------------


class LocalInference:
    """``pyannote.audio.Inference`` semantics for a local model.

    Chunks of ``model.duration`` seconds slide by ``step`` (default 10% of
    the duration, pyannote 2.x default); the ``pre_aggregation_hook`` maps
    each raw (chunk, frame, speaker) block before frames are aggregated
    onto the file clock by Hamming-weighted averaging. The windows run on
    the model's device; ``device``, when given, moves the model there, as
    ``pyannote.audio.Inference`` does.
    """

    def __init__(self, model: MiniPyanNet,
                 pre_aggregation_hook: Optional[Callable] = None,
                 step: Optional[float] = None, device=None):
        if device is not None:
            model = model.to(resolve_device(device))
        self.model = model
        self.hook = pre_aggregation_hook
        self.duration = model.duration
        self.step = step if step is not None else 0.1 * self.duration

    def _load(self, wav) -> np.ndarray:
        if isinstance(wav, np.ndarray):
            return wav.astype(np.float32)
        data, sr = read_audio(wav)
        if sr != self.model.SAMPLE_RATE:
            g = gcd(self.model.SAMPLE_RATE, sr)
            data = fast_resample_poly(
                data, self.model.SAMPLE_RATE // g, sr // g)
        return np.asarray(data, np.float32).reshape(-1)

    def chunked(self, wav):
        """Raw per-chunk model outputs BEFORE the hook and aggregation.

        Returns ``(out, windows, starts, n_samples)`` where ``out`` is the
        (chunks, frames, speakers) posterior block, ``windows`` the padded
        (chunks, chunk_samples) audio windows it was computed from, and
        ``starts`` the chunk start offsets in samples. The diarization
        pipeline consumes this to embed and cluster chunk-local speakers.
        """
        audio = self._load(wav)
        sr = self.model.SAMPLE_RATE
        chunk = int(self.duration * sr)
        hop = max(1, int(self.step * sr))
        n = len(audio)
        starts = list(range(0, max(1, n - chunk + hop), hop))

        windows = np.zeros((len(starts), chunk), np.float32)
        for i, s in enumerate(starts):
            piece = audio[s:s + chunk]
            windows[i, : len(piece)] = piece

        with torch.no_grad():
            out = self.model(torch.tensor(
                windows[:, None, :], device=self.model.device)).cpu().numpy()
        return out, windows, starts, n

    def __call__(self, wav) -> SlidingWindowFeature:
        out, _, starts, n = self.chunked(wav)
        sr = self.model.SAMPLE_RATE
        if self.hook is not None:
            out = self.hook(out)
        out = np.asarray(out)

        frames_per_chunk = out.shape[1]
        frame_step = self.duration / frames_per_chunk
        total_frames = int(round(n / sr / frame_step)) + 1
        dim = out.shape[2]
        acc = np.zeros((total_frames, dim), np.float64)
        wsum = np.zeros((total_frames, 1), np.float64)
        hamming = np.hamming(frames_per_chunk)[:, None]
        for i, s in enumerate(starts):
            f0 = int(round(s / sr / frame_step))
            f1 = min(f0 + frames_per_chunk, total_frames)
            acc[f0:f1] += out[i, : f1 - f0] * hamming[: f1 - f0]
            wsum[f0:f1] += hamming[: f1 - f0]
        data = acc / np.maximum(wsum, 1e-12)
        return SlidingWindowFeature(
            data.astype(np.float32),
            SlidingWindowFrames(0.0, frame_step, frame_step),
        )


# ---------------------------------------------------------------------------
# signal utils: Binarize + Peak (pyannote.audio.utils.signal semantics)
# ---------------------------------------------------------------------------


class Binarize:
    """Hysteresis binarization of a score track into active regions."""

    def __init__(self, onset: float = 0.5, offset: Optional[float] = None,
                 min_duration_on: float = 0.0,
                 min_duration_off: float = 0.0):
        self.onset = onset
        self.offset = offset if offset is not None else onset
        self.min_duration_on = min_duration_on
        self.min_duration_off = min_duration_off

    def __call__(self, track: SlidingWindowFeature) -> Timeline:
        y = track.data[:, 0]
        segs: List[Segment] = []
        active_since: Optional[float] = None
        for i, v in enumerate(y):
            t = track.frame_time(i)
            if active_since is None and v > self.onset:
                active_since = t
            elif active_since is not None and v < self.offset:
                segs.append(Segment(active_since, t))
                active_since = None
        if active_since is not None:
            segs.append(Segment(active_since, track.frame_time(len(y) - 1)))
        # merge gaps shorter than min_duration_off, drop short regions
        merged: List[Segment] = []
        for seg in segs:
            if merged and seg.start - merged[-1].end < self.min_duration_off:
                merged[-1] = Segment(merged[-1].start, seg.end)
            else:
                merged.append(seg)
        return Timeline([s for s in merged
                         if s.duration >= self.min_duration_on])


class Peak:
    """Local-maxima change detector: partition the extent at peaks."""

    def __init__(self, alpha: float = 0.05, min_duration: float = 1.0):
        self.alpha = alpha
        self.min_duration = min_duration

    def __call__(self, track: SlidingWindowFeature) -> Timeline:
        y = track.data[:, 0]
        n = len(y)
        min_dist = max(1, int(round(
            self.min_duration / track.sliding_window.step)))
        candidates = [
            i for i in range(1, n - 1)
            if y[i] > self.alpha and y[i] >= y[i - 1] and y[i] >= y[i + 1]
        ]
        # greedy distance suppression, strongest first (scipy find_peaks)
        peaks: List[int] = []
        for i in sorted(candidates, key=lambda i: -y[i]):
            if all(abs(i - j) >= min_dist for j in peaks):
                peaks.append(i)
        peaks.sort()
        times = [track.frame_time(i) for i in peaks]
        extent_end = track.frame_time(n - 1)
        bounds = [0.0] + times + [extent_end]
        return Timeline([
            Segment(a, b) for a, b in zip(bounds[:-1], bounds[1:])
        ])


# ---------------------------------------------------------------------------
# Diarization pipeline: segmentation -> embeddings -> clustering
# (pyannote ``speaker-diarization@2.1`` pipeline semantics, first-party)
# ---------------------------------------------------------------------------


class Annotation:
    """The minimal ``pyannote.core.Annotation`` surface the baseline uses:
    ``itertracks(yield_label=True)`` yielding (Segment, track, label) in
    chronological order."""

    def __init__(self):
        self._tracks: List[tuple] = []

    def add(self, segment: Segment, track, label) -> None:
        if segment.duration > 0.0:
            self._tracks.append((segment, track, label))

    def itertracks(self, yield_label: bool = False):
        ordered = sorted(
            self._tracks, key=lambda x: (x[0].start, x[0].end, str(x[2])))
        for seg, trk, lab in ordered:
            yield (seg, trk, lab) if yield_label else (seg, trk)

    def __len__(self):
        return len(self._tracks)


def spectral_embedding(samples: np.ndarray, n_fft: int = 512) -> np.ndarray:
    """First-party speaker embedding: mean log-magnitude spectrum over
    hann-windowed frames, L2-normalized.

    Stands in for pyannote's pretrained ECAPA embedding model (which needs
    HF-gated weights): it separates speakers by spectral envelope, which is
    exactly the cue the local synthetic checkpoints are built around, and
    is deterministic and dependency-free.
    """
    x = np.asarray(samples, np.float32).reshape(-1)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    hop = n_fft // 2
    window = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + (len(x) - n_fft) // hop
    spec = np.zeros(n_fft // 2 + 1, np.float64)
    for i in range(n_frames):
        frame = x[i * hop:i * hop + n_fft] * window
        spec += np.abs(np.fft.rfft(frame))
    spec /= max(1, n_frames)
    emb = np.log(spec + 1e-8)
    emb -= emb.mean()
    norm = np.linalg.norm(emb)
    return (emb / norm if norm > 0 else emb).astype(np.float32)


def agglomerative_cluster(
    embeddings: np.ndarray,
    num_clusters: Optional[int] = None,
    min_clusters: int = 1,
    max_clusters: Optional[int] = None,
    threshold: float = 0.7,
) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance.

    With ``num_clusters`` set, merges until exactly that many remain
    (pyannote's constrained mode when the caller passes ``num_speakers``);
    otherwise merges while the closest pair is nearer than ``threshold``,
    respecting ``min_clusters``/``max_clusters``. Returns integer labels.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int64)
    if num_clusters is not None:
        num_clusters = max(1, min(int(num_clusters), n))
    clusters: List[List[int]] = [[i] for i in range(n)]
    # cosine distance matrix once; average linkage = mean pairwise distance
    e = np.asarray(embeddings, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    dist = 1.0 - e @ e.T

    def linkage(a: List[int], b: List[int]) -> float:
        return float(dist[np.ix_(a, b)].mean())

    while len(clusters) > 1:
        k = len(clusters)
        best, bi, bj = None, -1, -1
        for i in range(k):
            for j in range(i + 1, k):
                d = linkage(clusters[i], clusters[j])
                if best is None or d < best:
                    best, bi, bj = d, i, j
        if num_clusters is not None:
            if k <= num_clusters:
                break
        else:
            over_max = max_clusters is not None and k > max_clusters
            if not over_max and (k <= min_clusters or best > threshold):
                break
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]

    labels = np.zeros(n, np.int64)
    # stable label order: cluster of the earliest member gets the lowest id
    clusters.sort(key=lambda c: min(c))
    for lab, members in enumerate(clusters):
        for m in members:
            labels[m] = lab
    return labels


class LocalDiarizationPipeline:
    """``pyannote/speaker-diarization@2.1`` pipeline semantics over the
    first-party local backend (reference model path:
    ``evaluations/pyannote/eval_pyannote.py:65-89``).

    Stages mirror pyannote's SpeakerDiarization pipeline: (1) sliding-window
    segmentation posteriors, (2) per-chunk binarized local speaker activity,
    (3) one embedding per active (chunk, local speaker) over its active
    samples, (4) constrained agglomerative clustering, (5) cluster-wise
    Hamming overlap-add of activations onto the file clock, binarized into
    final speaker turns. Called exactly like the reference:
    ``pipe(wav, min_speakers=1, num_speakers=2)``.
    """

    def __init__(self, model: MiniPyanNet, onset: float = 0.5,
                 offset: Optional[float] = None,
                 min_duration_on: float = 0.1,
                 min_duration_off: float = 0.1,
                 min_active_frames: int = 5,
                 clustering_threshold: float = 0.7):
        self.model = model
        self.inference = LocalInference(model)
        self.onset = onset
        self.offset = offset if offset is not None else onset
        self.min_duration_on = min_duration_on
        self.min_duration_off = min_duration_off
        self.min_active_frames = min_active_frames
        self.clustering_threshold = clustering_threshold

    @classmethod
    def from_pretrained(cls, path, use_auth_token=None, device=None):
        return cls(load_local_model(path, device=device))

    def to(self, device) -> "LocalDiarizationPipeline":
        """Move the segmentation model (``pyannote``'s ``Pipeline.to``)."""
        self.model.to(resolve_device(device))
        return self

    def __call__(self, wav, min_speakers: int = 1,
                 num_speakers: Optional[int] = None,
                 max_speakers: Optional[int] = None) -> Annotation:
        out, windows, starts, n = self.inference.chunked(wav)
        sr = self.model.SAMPLE_RATE
        n_chunks, frames_per_chunk, n_local = out.shape
        chunk_samples = windows.shape[1]
        samples_per_frame = chunk_samples / frames_per_chunk
        frame_step = self.inference.duration / frames_per_chunk

        # (2)+(3): embed every sufficiently active (chunk, local speaker)
        members: List[tuple] = []   # (chunk index, local speaker)
        embeddings: List[np.ndarray] = []
        for c in range(n_chunks):
            for s in range(n_local):
                active = out[c, :, s] > self.onset
                if int(active.sum()) < self.min_active_frames:
                    continue
                idx = np.flatnonzero(active)
                pieces = [
                    windows[c, int(i * samples_per_frame):
                            int((i + 1) * samples_per_frame)]
                    for i in idx
                ]
                members.append((c, s))
                embeddings.append(spectral_embedding(np.concatenate(pieces)))

        annotation = Annotation()
        if not members:
            return annotation

        labels = agglomerative_cluster(
            np.stack(embeddings), num_clusters=num_speakers,
            min_clusters=max(1, int(min_speakers)),
            max_clusters=max_speakers,
            threshold=self.clustering_threshold)
        n_clusters = int(labels.max()) + 1

        # (5): aggregate per-cluster activations onto the file clock.
        # Every chunk contributes to every cluster's normalization (an
        # absent speaker is evidence of silence, as in pyannote's
        # discrete stitching).
        total_frames = int(round(n / sr / frame_step)) + 1
        acc = np.zeros((total_frames, n_clusters), np.float64)
        wsum = np.zeros((total_frames, 1), np.float64)
        hamming = np.hamming(frames_per_chunk)
        chunk_cluster = np.zeros(
            (n_chunks, frames_per_chunk, n_clusters), np.float64)
        for (c, s), lab in zip(members, labels):
            chunk_cluster[c, :, lab] = np.maximum(
                chunk_cluster[c, :, lab], out[c, :, s])
        for c, s0 in enumerate(starts):
            f0 = int(round(s0 / sr / frame_step))
            f1 = min(f0 + frames_per_chunk, total_frames)
            acc[f0:f1] += chunk_cluster[c, : f1 - f0] * hamming[: f1 - f0,
                                                                None]
            wsum[f0:f1] += hamming[: f1 - f0, None]
        tracks = acc / np.maximum(wsum, 1e-12)

        binarize = Binarize(
            onset=self.onset, offset=self.offset,
            min_duration_on=self.min_duration_on,
            min_duration_off=self.min_duration_off)
        frames = SlidingWindowFrames(0.0, frame_step, frame_step)
        for k in range(n_clusters):
            label = f"SPEAKER_{k:02d}"
            timeline = binarize(
                SlidingWindowFeature(tracks[:, k:k + 1], frames))
            for t, seg in enumerate(timeline):
                annotation.add(seg, f"{label}_{t}", label)
        return annotation
