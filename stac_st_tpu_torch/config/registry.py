"""Symbol registry: maps the YAMLs' class paths onto the port's classes
(port of ``stac_st_tpu/config/registry.py``).

The reference hparams YAMLs instantiate ``speechbrain.*`` / ``torch.*`` /
recipe-local classes by dotted path (reference
``stac-st/hparams/transformer_multitask.yaml:173-318``). Every such path
is redirected here to the port's counterpart, so the repository's YAMLs
(``recipes/hparams/*.yaml``) load unchanged into PyTorch modules.

A path into the JAX package (``stac_st_tpu.<module>.<attr>``, as the
canonical YAML's comment names ``stac_st_tpu.ops.speed_perturb.
DeviceSpeedPerturb``) resolves to the same module and name under
``stac_st_tpu_torch``, or raises ``ImportError`` naming the path when the
port has no such name: the JAX package, JAX, flax and optax are never
imported. Other unknown paths fall back to a regular import, so user
extensions keep working.

Targets are registered lazily (as ``"module:attr"`` strings) to avoid import
cycles and to keep config loading fast.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

__all__ = ["resolve_symbol", "register", "REDIRECTS"]

# reference dotted path -> "stac_st_tpu_torch.module:attr"
REDIRECTS: Dict[str, str] = {
    # --- features / augmentation (yaml:283-302) ---
    "speechbrain.lobes.features.Fbank": "stac_st_tpu_torch.ops.fbank:Fbank",
    "speechbrain.processing.features.InputNormalization":
        "stac_st_tpu_torch.ops.cmvn:InputNormalization",
    "speechbrain.lobes.augment.SpecAugment":
        "stac_st_tpu_torch.ops.specaugment:SpecAugment",
    "speechbrain.processing.speech_augmentation.SpeedPerturb":
        "stac_st_tpu_torch.ops.speed_perturb:SpeedPerturb",
    # --- model stack (yaml:173-220) ---
    "speechbrain.lobes.models.convolution.ConvolutionFrontEnd":
        "stac_st_tpu_torch.models.frontend:ConvolutionFrontEnd",
    "modules.TransformerMultiTask.TransformerMultiTask":
        "stac_st_tpu_torch.models.multitask:TransformerMultiTask",
    "modules.TransformerMultiTask.EncoderWrapper":
        "stac_st_tpu_torch.models.multitask:EncoderWrapper",
    "speechbrain.nnet.linear.Linear":
        "stac_st_tpu_torch.models.multitask:LinearHead",
    "torch.nn.ModuleList": "stac_st_tpu_torch.models.multitask:ModuleGroup",
    # --- decoding (yaml:228-251) ---
    "modules.mutitask_decoder.S2SMultiTaskTransformerBeamSearch":
        "stac_st_tpu_torch.decoding.beam_search:MultiTaskBeamSearch",
    # --- losses (yaml:253-262) ---
    "torch.nn.LogSoftmax": "stac_st_tpu_torch.ops.losses:LogSoftmax",
    "speechbrain.nnet.losses.ctc_loss": "stac_st_tpu_torch.ops.ctc:ctc_loss",
    "speechbrain.nnet.losses.nll_loss":
        "stac_st_tpu_torch.ops.losses:nll_loss",
    "speechbrain.nnet.losses.kldiv_loss":
        "stac_st_tpu_torch.ops.losses:kldiv_loss",
    # --- optimization (yaml:223-224, 264-269) ---
    "torch.optim.AdamW": "stac_st_tpu_torch.training.optim:AdamW",
    "torch.optim.Adam": "stac_st_tpu_torch.training.optim:Adam",
    "speechbrain.nnet.schedulers.WarmCoolDecayLRSchedule":
        "stac_st_tpu_torch.training.schedulers:WarmCoolDecayLRSchedule",
    "speechbrain.nnet.schedulers.NoamScheduler":
        "stac_st_tpu_torch.training.schedulers:NoamScheduler",
    # --- activations ---
    "torch.nn.GELU": "stac_st_tpu_torch.models.activations:GELU",
    "torch.nn.ReLU": "stac_st_tpu_torch.models.activations:ReLU",
    "torch.nn.LeakyReLU": "stac_st_tpu_torch.models.activations:LeakyReLU",
    "speechbrain.nnet.activations.Swish":
        "stac_st_tpu_torch.models.activations:Swish",
    # --- trainer plumbing (yaml:272-319) ---
    "speechbrain.utils.checkpoints.Checkpointer":
        "stac_st_tpu_torch.training.checkpoint:Checkpointer",
    "speechbrain.utils.epoch_loop.EpochCounter":
        "stac_st_tpu_torch.training.lifecycle:EpochCounter",
    "speechbrain.utils.train_logger.FileTrainLogger":
        "stac_st_tpu_torch.utils.logger:FileTrainLogger",
    "speechbrain.utils.parameter_transfer.Pretrainer":
        "stac_st_tpu_torch.training.lifecycle:Pretrainer",
    # --- metrics (yaml:308-311) ---
    "speechbrain.utils.bleu.BLEUStats":
        "stac_st_tpu_torch.utils.metrics:BLEUStats",
    "speechbrain.utils.Accuracy.AccuracyStats":
        "stac_st_tpu_torch.utils.metrics:AccuracyStats",
    "speechbrain.utils.metric_stats.ErrorRateStats":
        "stac_st_tpu_torch.utils.metrics:ErrorRateStats",
    # --- tokenizer (yaml:36; tokenizer yaml:32) ---
    "sentencepiece.SentencePieceProcessor":
        "stac_st_tpu_torch.tokenizer.sentencepiece_compat:"
        "SentencePieceProcessor",
    "speechbrain.tokenizers.SentencePiece.SentencePiece":
        "stac_st_tpu_torch.tokenizer.train:SentencePiece",
    # --- misc (yaml:23) ---
    "torch.manual_seed": "stac_st_tpu_torch.utils.seeding:manual_seed",
}


def register(path: str, target: str) -> None:
    """Register/override a redirect (``target`` is ``"module:attr"``)."""
    REDIRECTS[path] = target


def _import_target(target: str) -> Any:
    module_name, _, attr = target.partition(":")
    module = importlib.import_module(module_name)
    obj: Any = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


_JAX_PACKAGE = "stac_st_tpu"
_NEVER_IMPORTED = ("jax", "jaxlib", "flax", "optax")


def _import_walk(parts) -> Any:
    """The object at a dotted path, walking module.attr boundaries right
    to left; None when no split imports."""
    for split in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:split])
        try:
            module = importlib.import_module(module_name)
        except ImportError:
            continue
        obj: Any = module
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    return None


def resolve_symbol(path: str) -> Callable:
    """Resolve a dotted path from YAML to a callable/class."""
    if path in REDIRECTS:
        return _import_target(REDIRECTS[path])
    parts = path.split(".")
    if parts[0] == _JAX_PACKAGE:
        obj = _import_walk(["stac_st_tpu_torch"] + parts[1:])
        if obj is None:
            raise ImportError(
                f"cannot resolve {path!r}: stac_st_tpu_torch has no "
                f"{'.'.join(parts[1:])!r} (the JAX package is not imported)")
        return obj
    if parts[0] in _NEVER_IMPORTED:
        raise ImportError(f"cannot resolve {path!r}: the port does not "
                          f"import {parts[0]}")
    obj = _import_walk(parts)
    if obj is None:
        raise ImportError(
            f"cannot resolve {path!r}: not in the redirect registry and not "
            f"importable. Register a port equivalent via "
            f"stac_st_tpu_torch.config.registry.register()."
        )
    return obj
