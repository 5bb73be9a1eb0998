"""The model settings the port checks, and the rule that refuses the rest.

The port computes every setting the JAX package computes: pre-LN and
post-LN layers, the Transformer and the Conformer encoder, regular and
relative-position (``RelPosMHAXL``) attention, causal Conformer
convolutions, and residual or deeper conv blocks. It refuses only what the
JAX package refuses or cannot compute:

* an ``attention_type`` or ``encoder_module`` outside the two values each
  (the JAX ``TransformerMultiTask`` raises ``NotImplementedError``);
* a front end with more blocks than ``out_channels`` entries (the JAX
  module indexes past them);
* a parameter tree loaded into a port module whose settings compute
  another network from the same keys: a different ``nhead``, layer-norm
  placement, encoder, attention type, or (for a Conformer) causality or
  kernel size (``interop.from_jax.check_settings``).

Each refusal is a ``ValueError`` that names the field.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["ATTENTION_TYPES", "ENCODER_MODULES", "require", "require_one_of",
           "check_model"]

ATTENTION_TYPES = ("regularMHA", "RelPosMHAXL")
ENCODER_MODULES = ("transformer", "conformer")


def require(owner: str, field: str, got: Any, want: Any) -> None:
    """Raise ``ValueError`` naming ``field`` unless ``got == want``."""
    if got != want:
        raise ValueError(f"{owner} {field}={got!r}: expected "
                         f"{field}={want!r}")


def require_one_of(owner: str, field: str, got: Any, allowed) -> None:
    """Raise ``ValueError`` naming ``field`` unless ``got`` is allowed."""
    if got not in allowed:
        raise ValueError(f"{owner} {field}={got!r}: the JAX package runs "
                         f"only {field} in {tuple(allowed)!r}")


def check_model(owner: str, get: Callable[[str], Any]) -> None:
    """The two fields of ``TransformerMultiTask`` the JAX package checks,
    as ``get`` reads them."""
    require_one_of(owner, "attention_type", get("attention_type"),
                   ATTENTION_TYPES)
    require_one_of(owner, "encoder_module", get("encoder_module"),
                   ENCODER_MODULES)
