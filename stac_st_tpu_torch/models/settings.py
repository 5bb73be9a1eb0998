"""The model settings the port runs, and the one rule that refuses the rest.

The JAX package accepts settings the port does not compute (post-LN,
causal encoders, conformer and relative-position attention, residual or
deeper conv blocks). Wherever such
a setting reaches the port (a YAML constructing a module, or
``interop.from_jax.load_jax_params`` reading a JAX module's settings), it
is refused by :func:`require`, which names the field.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["PORT_SETTINGS", "require", "require_transformer"]

# The JAX ``TransformerMultiTask`` settings the port's model computes; any
# other value is another network with the same parameter keys.
PORT_SETTINGS = {
    "normalize_before": True,
    "causal": False,
    "encoder_module": "transformer",
    "attention_type": "regularMHA",
    "positional_encoding": "fixed_abs_sine",
}


def require(owner: str, field: str, got: Any, want: Any) -> None:
    """Raise ``ValueError`` naming ``field`` unless ``got == want``."""
    if got != want:
        raise ValueError(f"{owner} {field}={got!r}: the port runs only "
                         f"{field}={want!r}")


def require_transformer(owner: str, get: Callable[[str], Any],
                        nhead: int) -> None:
    """Every field of ``PORT_SETTINGS``, and ``nhead``, as ``get`` reads
    them, must be the port's."""
    for field, want in {**PORT_SETTINGS, "nhead": nhead}.items():
        require(owner, field, get(field), want)
