"""TransformerMultiTask: the joint ASR+ST encoder-decoder.

Port of ``stac_st_tpu/models/multitask.py``: linear source projection
(+ dropout in training), fixed sinusoidal positions, the teacher-forced
``forward`` / ``forward_decoder`` (round-based key padding, lookahead |
target padding), the serving ``encode`` (floor-based key padding, plain
attention), the oracle full-prefix ``decode``, and the KV-cached
``decode_step`` with its cache (``init_decode_cache`` /
``grow_decode_cache``, ``set_cache_index``), plus the two steps
continuous batching runs: ``decode_window`` (the prompt, w positions at
once; speculative decoding's verify step) and ``decode_step_rows`` (one
step of R slots, each at its own position). The cache may be int8
(``cache_dtype='int8'``, beam-1 layout). The task is selected by the
decoder prompt ``[bos, source_lang, target_lang]``.

The YAML-facing classes (``TransformerMultiTask``, ``LinearHead``,
``ModuleGroup``, ``EncoderWrapper``) are what the registry resolves the
reference hparams onto. The constructor takes the JAX module's settings
(``normalize_before``, ``causal``, ``encoder_module``, ``attention_type``,
``positional_encoding``) and keeps them as attributes, so a port model
describes itself to ``interop.from_jax.load_jax_params`` as a JAX one
does; any value the port does not compute raises, through the same rule
as the loader (``models.settings``). Unlike the JAX module, whose
``normalize_before`` defaults to False, the port's defaults to True (the
only placement it runs; every YAML of the repository sets it).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..ops import masks as M
from .activations import default_activation
from .dropout import StepRandom, dropout
from .positional import sinusoidal_table
from .settings import require_transformer
from .transformer import (
    NormalizedEmbedding,
    TransformerDecoder,
    TransformerEncoder,
)

__all__ = ["TransformerMultiTask", "LinearHead", "ModuleGroup",
           "EncoderWrapper", "glorot_init_"]

MAX_LENGTH = 2500  # sinusoidal table rows (reference max_length)


def _as_callable(activation: Any) -> Callable:
    """The JAX module's rule: None -> the default, a class -> an
    instance of it."""
    if activation is None:
        return default_activation
    return activation() if isinstance(activation, type) else activation


class TransformerMultiTask(nn.Module):
    def __init__(self, tgt_vocab: int, input_size: int, d_model: int = 512,
                 nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, d_ffn: int = 2048,
                 activation: Any = default_activation,
                 dropout: float = 0.1, normalize_before: bool = True,
                 causal: bool = False, encoder_module: str = "transformer",
                 attention_type: str = "regularMHA",
                 positional_encoding: str = "fixed_abs_sine"):
        """Pre-LN only; positions up to ``MAX_LENGTH``. ``dropout`` acts
        only in the training forward. ``activation``: a callable, or a
        class (as a YAML's ``!name:torch.nn.GELU`` gives it) that is
        instantiated; None is ``default_activation``."""
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.normalize_before, self.causal = normalize_before, causal
        self.encoder_module = encoder_module
        self.attention_type = attention_type
        self.positional_encoding = positional_encoding
        require_transformer("TransformerMultiTask",
                            lambda field: getattr(self, field), nhead)
        activation = _as_callable(activation)
        self.dropout = float(dropout)
        self.src_proj = nn.Linear(input_size, d_model)
        self.tgt_embed = NormalizedEmbedding(d_model, tgt_vocab)
        self.encoder = TransformerEncoder(num_encoder_layers, d_model, nhead,
                                          d_ffn, activation, dropout)
        self.decoder = TransformerDecoder(num_decoder_layers, d_model, nhead,
                                          d_ffn, activation, dropout)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(MAX_LENGTH, d_model)),
            persistent=False)

    @staticmethod
    def _flatten_src(src: torch.Tensor) -> torch.Tensor:
        """(B, T, F, C) conv features -> (B, T, F·C), F major."""
        if src.dim() == 4:
            b, t, f, c = src.shape
            src = src.reshape(b, t, f * c)
        return src

    def _add_pe(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, : x.shape[1], :].to(x.dtype)

    def _src_bias(self, wav_len: Optional[torch.Tensor], S: int):
        if wav_len is None:
            return None
        pad = M.src_key_padding_mask(wav_len, S)  # round-based
        return M.additive_bias(pad[:, None, None, :])

    # ------------------------------------------------------------- forward
    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                wav_len: Optional[torch.Tensor] = None, pad_idx: int = 0,
                train: bool = False, rng: Optional[StepRandom] = None):
        """Teacher-forced forward -> (encoder_out, decoder_out). With
        ``train`` dropout is on and key-padding attention runs through
        ``flash_attention_train``; without, through ``flash_attention``."""
        src = self._flatten_src(src)
        h = self.src_proj(src)
        if train:
            h = dropout(h, self.dropout, rng)
        enc = self.encoder(self._add_pe(h), self._src_bias(wav_len,
                                                          src.shape[1]),
                           "train" if train else "eval", rng)
        return enc, self.forward_decoder(tgt, enc, wav_len, pad_idx, train,
                                         rng)

    def forward_decoder(self, tgt: torch.Tensor, encoder_out: torch.Tensor,
                        wav_len: Optional[torch.Tensor] = None,
                        pad_idx: int = 0, train: bool = False,
                        rng: Optional[StepRandom] = None) -> torch.Tensor:
        """Decoder half of the teacher-forced forward: lookahead | target
        padding on self-attention, round-based padding on cross."""
        T = tgt.shape[1]
        tgt_pad = M.tgt_key_padding_mask(tgt, pad_idx)
        self_bias = M.additive_bias(
            M.lookahead_mask(T, tgt.device)[None, None, :, :]
            | tgt_pad[:, None, None, :])
        d = self._add_pe(self.tgt_embed(tgt))
        return self.decoder(d, encoder_out, self_bias,
                            self._src_bias(wav_len, encoder_out.shape[1]),
                            "train" if train else "eval", rng)

    # -------------------------------------------------------------- encode
    def encode(self, src: torch.Tensor,
               wav_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inference encoder pass (floor-based key padding mask)."""
        src = self._flatten_src(src)
        bias = None
        if wav_len is not None:
            pad = M.src_key_padding_mask_encode(wav_len, src.shape[1])
            bias = M.additive_bias(pad[:, None, None, :])
        return self.encoder(self._add_pe(self.src_proj(src)), bias)

    # ------------------------------------------------- full-prefix decode
    def decode(self, tgt: torch.Tensor, encoder_out: torch.Tensor,
               enc_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Oracle full-prefix decode, no KV cache: tgt (B, T) -> (B, T, d).
        enc_len: absolute encoder lengths or None (no cross mask)."""
        T = tgt.shape[1]
        self_bias = M.additive_bias(
            M.lookahead_mask(T, tgt.device)[None, None, :, :])
        cross_bias = None
        if enc_len is not None:
            S = encoder_out.shape[1]
            pad = (torch.arange(S, device=tgt.device)[None, :]
                   >= enc_len[:, None])
            cross_bias = M.additive_bias(pad[:, None, None, :])
        d = self._add_pe(self.tgt_embed(tgt))
        return self.decoder(d, encoder_out, self_bias, cross_bias)

    # --------------------------------------------------- KV-cached decode
    def init_decode_cache(self, encoder_out: torch.Tensor, max_len: int,
                          enc_mask_bias: Optional[torch.Tensor] = None,
                          beam: int = 1, anc_mode: bool = False,
                          cache_dtype: Optional[str] = None
                          ) -> Dict[str, Any]:
        """encoder_out (B, S, d), untiled; self caches get B·beam rows.
        enc_mask_bias: additive fp32 cross-attention bias, (B, S) or the
        reference's (B, 1, 1, S), kept as (B, S); or None. anc_mode adds
        the ancestor table ``anc`` (B, beam, max_len) int32, initially the
        identity. ``cache_dtype``: None (the model's dtype) or 'int8' (the
        quantized self and cross caches with their fp32 scales; not with
        anc_mode)."""
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype: {cache_dtype!r} (supported: "
                             "None, 'int8')")
        B, S = encoder_out.shape[:2]
        if enc_mask_bias is not None:
            enc_mask_bias = enc_mask_bias.reshape(B, S).float().contiguous()
        cache = {
            "layers": self.decoder.init_cache(B * beam, max_len, encoder_out,
                                              anc_mode, cache_dtype),
            "enc_bias": enc_mask_bias,
        }
        if anc_mode:
            cache["anc"] = (
                torch.arange(beam, dtype=torch.int32,
                             device=encoder_out.device)[None, :, None]
                .expand(B, beam, max_len).contiguous())
        return cache

    @staticmethod
    def grow_decode_cache(cache: Dict[str, Any], new_max_len: int
                          ) -> Dict[str, Any]:
        """Re-allocate the self caches (their int8 scales, the ancestor
        table) at a larger step budget, zero-padded, keeping contents and
        the write index."""
        anc_mode = cache.get("anc") is not None

        def pad(t: torch.Tensor, dim: int) -> torch.Tensor:
            shape = list(t.shape)
            shape[dim] = new_max_len
            out = t.new_zeros(shape)
            out.narrow(dim, 0, t.shape[dim]).copy_(t)
            return out

        for layer in cache["layers"]:
            sc = layer["self"]
            sc["k"] = pad(sc["k"], 2 if anc_mode else 3)
            sc["v"] = pad(sc["v"], 2)
            for name in ("k_scale", "v_scale"):  # int8 cache
                if name in sc:
                    sc[name] = pad(sc[name], 3)
        if anc_mode:
            cache["anc"] = pad(cache["anc"], 2)
        return cache

    @staticmethod
    def set_cache_index(cache: Dict[str, Any], index: int) -> None:
        """Rewind (or set) every self cache's write index, in place.
        Speculative decoding appends a whole window and keeps the accepted
        prefix: rows past the index are masked, and the next window, which
        starts at the index, overwrites them before they can be read."""
        for layer in cache["layers"]:
            layer["self"]["index"] = index

    def decode_step(self, tokens: torch.Tensor, position: int,
                    cache: Dict[str, Any]) -> torch.Tensor:
        """tokens (B·beam,) at ``position`` (host int) -> hidden (B·beam, d).
        Updates ``cache`` in place."""
        emb = self.tgt_embed(tokens) + self.pe[position].to(
            self.tgt_embed.embed.weight.dtype)
        beam = tokens.shape[0] // cache["layers"][0]["cross_k"].shape[0]
        return self.decoder.step(emb, cache["layers"], cache["enc_bias"],
                                 beam, anc=cache.get("anc"))

    def decode_window(self, tokens: torch.Tensor, position: int,
                      cache: Dict[str, Any]) -> torch.Tensor:
        """tokens (B, w) at positions position..position+w-1 (``position``,
        a host int, equals the cache's write index) -> hidden (B, w, d);
        the index advances by w. Equal to w ``decode_step`` calls."""
        w = tokens.shape[1]
        emb = self.tgt_embed(tokens) + self.pe[position:position + w].to(
            self.tgt_embed.embed.weight.dtype)[None]
        return self.decoder.step_window(emb, cache["layers"],
                                        cache["enc_bias"])

    def decode_step_rows(self, tokens: torch.Tensor, positions: torch.Tensor,
                         cache: Dict[str, Any]) -> torch.Tensor:
        """One step of R slots at per-row positions (continuous batching):
        tokens (R,), positions (R,) on the device (the sinusoidal row of
        each, clipped to the table), every layer's self-cache ``index`` a
        (R,) int32 tensor; beam 1. Returns hidden (R, d); every slot's
        index advances by one."""
        pos = positions.clamp(0, self.pe.shape[0] - 1).long()
        emb = self.tgt_embed(tokens) + self.pe[pos].to(
            self.tgt_embed.embed.weight.dtype)
        return self.decoder.step(emb, cache["layers"], cache["enc_bias"], 1)


class LinearHead(nn.Module):
    """Output projection head (seq_lin / ctc_lin)."""

    def __init__(self, input_size: int, n_neurons: int):
        super().__init__()
        self.linear = nn.Linear(input_size, n_neurons)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class ModuleGroup:
    """Stand-in for ``torch.nn.ModuleList`` groupings in YAML (the
    ``model`` recoverable: CNN, Transformer, seq_lin, ctc_lin). Holds the
    very modules the YAML's ``!ref`` names, so it shares them with
    ``modules`` and the searchers."""

    def __init__(self, modules: Sequence[Any]):
        self.modules = list(modules)

    def __iter__(self):
        return iter(self.modules)

    def __len__(self):
        return len(self.modules)


class EncoderWrapper(nn.Module):
    """Reference ``EncoderWrapper``: forward == ``encode``."""

    def __init__(self, transformer: TransformerMultiTask, *args, **kwargs):
        super().__init__()
        self.transformer = transformer

    def forward(self, x: torch.Tensor,
                wav_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.transformer.encode(x, wav_lens)


@torch.no_grad()
def glorot_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights as the reference initializes them: Glorot
    (Xavier) normal for Linear, Conv2d and Embedding weights, zero biases,
    unit LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Embedding)):
            w = m.weight
            receptive = math.prod(w.shape[2:]) if w.dim() > 2 else 1
            fan_out, fan_in = w.shape[0] * receptive, w.shape[1] * receptive
            std = math.sqrt(2.0 / (fan_in + fan_out))
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
