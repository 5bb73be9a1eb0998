"""CTC prefix scores of candidate continuations: the CUDA kernel and its
plain version.

Replaces no TPU kernel: the JAX package scores the candidates of a joint
CTC/attention decode step with an XLA ``lax.scan`` over the encoder frames
(``stac_st_tpu/decoding/ctc_prefix.py:126``, ``ctc_prefix_score_all``). As
plain PyTorch that scan is a Python loop of T frames × a few small kernels
inside every decode step, so the port computes it in one kernel a step
(``csrc/ctc_prefix.cu``): one warp a (row, candidate) lane scans the
frames as affine maps in the log semiring, tile by tile of 256 frames,
a block's warps sharing the row's frame terms staged in shared memory.
The scan cuts each lane's chain of T dependent logaddexps to about 30 a
tile, which leaves the kernel bound by its gather of the candidates'
posterior columns (a sector a candidate and frame); shared memory holds
one tile whatever T is, so T has no cap.

``ctc_prefix_score`` given CPU tensors returns :func:`ctc_prefix_score_ref`.
Given CUDA tensors it checks dtype, shape and contiguity, launches the
kernel on the current stream, raises if the launch failed, and counts it
under ``ctc_prefix_score``. There is no fallback from a CUDA tensor to the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import count_launch, load_library
from .train_attention import on_cpu

__all__ = ["ctc_prefix_score", "ctc_prefix_score_ref", "logaddexp",
           "KERNELS", "NEG_INF"]

NEG_INF = -1.0e9
_LIB = "ctc_prefix"
_P = ctypes.c_void_p
_I = ctypes.c_int

KERNELS = {
    "ctc_prefix_score": (
        "none: the XLA lax.scan in stac_st_tpu/decoding/ctc_prefix.py:126 "
        "(ctc_prefix_score_all)",
        "stac_st_tpu_torch/csrc/ctc_prefix.cu"),
}


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max + log1p(exp(-|a - b|)): the formula of ``jnp.logaddexp``."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def ctc_prefix_score_ref(log_probs: torch.Tensor, r_nb: torch.Tensor,
                         r_b: torch.Tensor, last: torch.Tensor,
                         cand: Optional[torch.Tensor],
                         input_lengths: torch.Tensor, blank: int = 0,
                         eos: int = 2, beam: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score the candidates of BB = B·beam prefixes.

    log_probs (B, T, V) fp32, one per utterance (row r reads r // beam);
    r_nb, r_b (BB, T) the prefixes' forward variables; last (BB,) their
    last labels (-1 for the empty prefix); cand (BB, K) token ids, or None
    for the whole vocabulary (K = V); input_lengths (BB,) valid frames.
    Returns scores (BB, K) and the candidates' forward variables nb_all,
    b_all (BB, K, T), as ``stac_st_tpu``'s ``ctc_prefix_score_all``."""
    B, T, V = log_probs.shape
    BB = r_nb.shape[0]
    dev = log_probs.device
    utt = torch.arange(BB, device=dev) // beam
    lp_t = log_probs.float().transpose(1, 2)  # (B, V, T)
    if cand is None:
        cand = torch.arange(V, device=dev).expand(BB, V)
    x = lp_t[utt[:, None], cand]  # (BB, K, T)
    xb = lp_t[utt, blank]  # (BB, T)
    K = cand.shape[1]
    same = cand == last[:, None]
    phi = torch.where(same[:, :, None], r_b[:, None, :],
                      logaddexp(r_nb, r_b)[:, None, :])  # (BB, K, T)
    phi_m1 = torch.where(last < 0, 0.0, NEG_INF)[:, None].expand(BB, K)
    nb = torch.full((BB, K), NEG_INF, device=dev)
    b = torch.full((BB, K), NEG_INF, device=dev)
    nb_all = torch.empty((BB, K, T), device=dev)
    b_all = torch.empty((BB, K, T), device=dev)
    prev_phi = phi_m1
    for t in range(T):
        nb_t = logaddexp(nb, prev_phi) + x[:, :, t]
        b_t = logaddexp(b, nb) + xb[:, t, None]
        nb_all[:, :, t] = nb_t
        b_all[:, :, t] = b_t
        nb, b, prev_phi = nb_t, b_t, phi[:, :, t]
    # ψ = logsumexp over valid frames of φ[t-1] + x[t]
    phi_shifted = torch.cat([phi_m1[:, :, None], phi[:, :, :-1]], dim=2)
    valid = (torch.arange(T, device=dev)[None, None, :]
             < input_lengths[:, None, None])
    scores = torch.logsumexp(
        torch.where(valid, phi_shifted + x, NEG_INF), dim=2)
    # eos: the probability that the current prefix is the whole output
    idx = (input_lengths.long() - 1).clamp(min=0)
    rows = torch.arange(BB, device=dev)
    done = logaddexp(r_nb[rows, idx], r_b[rows, idx])
    scores = torch.where(cand == eos, done[:, None], scores)
    scores = torch.where(cand == blank, NEG_INF, scores)
    return scores, nb_all, b_all


def _lib():
    lib = load_library(_LIB)
    if not getattr(lib, "_stac_bound", False):
        lib.stac_ctc_prefix_score.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        lib.stac_ctc_prefix_score.restype = _I
        lib.stac_ctc_error_string.argtypes = [_I]
        lib.stac_ctc_error_string.restype = ctypes.c_char_p
        lib._stac_bound = True
    return lib


def ctc_prefix_score(log_probs: torch.Tensor, r_nb: torch.Tensor,
                     r_b: torch.Tensor, last: torch.Tensor,
                     cand: Optional[torch.Tensor],
                     input_lengths: torch.Tensor, blank: int = 0,
                     eos: int = 2, beam: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See :func:`ctc_prefix_score_ref`. On the card: log_probs, r_nb and
    r_b fp32; last, cand and input_lengths int64; all contiguous."""
    if on_cpu(log_probs, r_nb, r_b, last, cand, input_lengths):
        return ctc_prefix_score_ref(log_probs, r_nb, r_b, last, cand,
                                    input_lengths, blank, eos, beam)
    name = "ctc_prefix_score"
    B, T, V = log_probs.shape
    BB = r_nb.shape[0]
    K = V if cand is None else cand.shape[1]
    if BB != B * beam:
        raise ValueError(f"{name}: {BB} rows != {B} utterances x beam {beam}")
    if not (0 <= blank < V and 0 <= eos < V):
        raise ValueError(f"{name}: blank {blank} / eos {eos} outside [0, {V})")
    want = {"log_probs": (log_probs, (B, T, V), torch.float32),
            "r_nb": (r_nb, (BB, T), torch.float32),
            "r_b": (r_b, (BB, T), torch.float32),
            "last": (last, (BB,), torch.int64),
            "input_lengths": (input_lengths, (BB,), torch.int64)}
    if cand is not None:
        want["cand"] = (cand, (BB, K), torch.int64)
    for label, (t, shape, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    lib = _lib()
    scores = torch.empty((BB, K), device=r_nb.device)
    nb_all = torch.empty((BB, K, T), device=r_nb.device)
    b_all = torch.empty((BB, K, T), device=r_nb.device)
    rc = lib.stac_ctc_prefix_score(
        log_probs.data_ptr(), r_nb.data_ptr(), r_b.data_ptr(),
        last.data_ptr(), None if cand is None else cand.data_ptr(),
        input_lengths.data_ptr(), scores.data_ptr(), nb_all.data_ptr(),
        b_all.data_ptr(), BB, K, T, V, beam, blank, eos,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.stac_ctc_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")
    count_launch(name)
    return scores, nb_all, b_all
