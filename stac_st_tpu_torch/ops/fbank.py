"""Log-mel filterbank features (port of ``stac_st_tpu/ops/fbank.py``).

16 kHz audio -> STFT(n_fft=400, hop=160, periodic hamming, centre
zero-padding) -> power spectrum -> 80 triangular HTK-mel filters -> dB
with a ``top_db`` clamp. The windowed DFT is one framed matmul against a
fixed (n_fft, 2·n_bins) kernel, in full fp32 (the reference uses
``Precision.HIGHEST``; on the card the caller keeps TF32 off).

The ``top_db`` clamp takes its max over the WHOLE batch tensor, as the
reference does: an utterance's features depend on its batch mates. Where
the batch is split over ranks or shards, ``reduce_max`` takes that max
over the global batch (the JAX mesh computes it globally), or the caller
computes :meth:`Fbank.db` per shard and clamps with the shards' max.
Frame count: ``T = 1 + L // hop``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Fbank", "mel_filterbank", "num_frames"]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """(n_bins, n_mels) triangular HTK-mel matrix over 0..sample_rate/2
    (SpeechBrain-compatible)."""
    n_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    f_central = hz_pts[1:-1]
    band = hz_pts[2:] - hz_pts[1:-1]
    slope = (all_freqs[:, None] - f_central[None, :]) / band[None, :]
    fbank = np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))
    return fbank.astype(np.float32)


def num_frames(n_samples: int, hop_length: int = 160) -> int:
    return 1 + n_samples // hop_length


class Fbank:
    """Call with (B, L) fp32 waveforms on any device -> (B, T, n_mels)."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 400,
                 n_mels: int = 80, top_db: float = 80.0):
        self.sample_rate = int(sample_rate)
        self.n_fft = int(n_fft)
        self.n_mels = int(n_mels)
        self.hop_length = int(round(10.0 * self.sample_rate / 1000))  # 10 ms
        win_length = int(round(25.0 * self.sample_rate / 1000))  # 25 ms
        self.top_db = float(top_db)

        n_bins = self.n_fft // 2 + 1
        window = np.hamming(win_length + 1)[:-1].astype(np.float64)
        if win_length < self.n_fft:  # centre the window in the FFT frame
            lpad = (self.n_fft - win_length) // 2
            window = np.pad(window, (lpad, self.n_fft - win_length - lpad))
        k = np.arange(self.n_fft)[None, :]
        bins = np.arange(n_bins)[:, None]
        angle = -2.0 * math.pi * bins * k / self.n_fft
        kernel = np.concatenate(
            [np.cos(angle) * window[None, :], np.sin(angle) * window[None, :]],
            axis=0,
        )  # (2·n_bins, n_fft)
        self._dft = torch.from_numpy(kernel.T.astype(np.float32).copy())
        self._mel = torch.from_numpy(
            mel_filterbank(self.n_mels, self.n_fft, self.sample_rate))
        self._on: dict = {}

    def _consts(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (self._dft.to(device), self._mel.to(device))
        return self._on[device]

    def __call__(self, wavs: torch.Tensor, reduce_max=None) -> torch.Tensor:
        """``reduce_max``: called with this batch's max dB (a 0-d tensor)
        and returning the global batch's."""
        x_db = self.db(wavs)
        top = x_db.max()
        if reduce_max is not None:
            top = reduce_max(top)
        return self.clamp(x_db, top)

    def clamp(self, x_db: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
        """The ``top_db`` floor below the batch's max dB ``top``."""
        return torch.maximum(x_db, top - self.top_db)

    def db(self, wavs: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_mels) log-mel dB before the clamp."""
        dft, mel_m = self._consts(wavs.device)
        pad = self.n_fft // 2
        x = torch.nn.functional.pad(wavs.to(torch.float32), (pad, pad))
        frames = x.unfold(1, self.n_fft, self.hop_length)  # (B, T, n_fft)
        spec = torch.matmul(frames, dft)  # (B, T, 2·n_bins)
        n_bins = dft.shape[1] // 2
        re, im = spec[..., :n_bins], spec[..., n_bins:]
        power = re * re + im * im
        mel = torch.matmul(power, mel_m)  # (B, T, n_mels)
        return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))

    def output_frames(self, n_samples: int) -> int:
        return num_frames(n_samples, self.hop_length)
