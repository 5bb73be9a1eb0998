"""HyperPyYAML-compatible configuration loader (copy of
``stac_st_tpu/config/hyperyaml.py``).

The reference stack (amazon-science/stac-speech-translation) uses YAML as its
composition root: hparams files *instantiate* the model, losses, searchers,
scheduler and checkpointer through ``!new:``/``!name:``/``!apply:`` tags with
``!ref`` cross-references and CLI ``--key=value`` overrides (see reference
``stac-st/train_multitask.py:626-630`` and
``stac-st/hparams/transformer_multitask.yaml:173-318``).

This module re-implements that surface on plain PyYAML so the reference
hparams files load unchanged, with one twist: dotted class paths are resolved
through :mod:`stac_st_tpu_torch.config.registry`, which maps the
reference's ``speechbrain.*`` / ``torch.*`` names (and the JAX package's
``stac_st_tpu.*`` paths) onto the port's classes.

Supported tags
--------------
``!ref <key>``        reference another key (shares object identity);
                      string interpolation (``!ref <folder>/save``) and
                      arithmetic (``!ref <steps>*0.1``) are supported.
``!copy <key>``       like !ref but deep-copies the resolved value.
``!new:pkg.Cls``      instantiate (mapping → kwargs, sequence → args).
``!name:pkg.fn``      partial application (or the bare callable).
``!apply:pkg.fn``     call at load time.
``!PLACEHOLDER``      must be overridden (CLI or overrides dict) or loading
                      fails with the key name.

Also replicated: HyperPyYAML's implicit tuple resolver, so plain values like
``(256, 256)`` load as tuples (reference yaml:174-180 relies on this).
"""

from __future__ import annotations

import ast
import copy
import functools
import operator
import re
from typing import Any, Dict, Iterable, Optional

import yaml

from . import registry

__all__ = [
    "load_hyperpyyaml",
    "dump_resolved_yaml",
    "Placeholder",
    "HyperYamlError",
]


class HyperYamlError(Exception):
    """Raised for malformed hyper-YAML or unresolved placeholders."""


class Placeholder:
    """Sentinel for ``!PLACEHOLDER`` values."""

    def __repr__(self) -> str:  # pragma: no cover
        return "!PLACEHOLDER"


class _Ref:
    __slots__ = ("expr", "deep_copy")

    def __init__(self, expr: str, deep_copy: bool = False):
        self.expr = expr
        self.deep_copy = deep_copy

    def __repr__(self) -> str:  # pragma: no cover
        return f"!{'copy' if self.deep_copy else 'ref'} {self.expr!r}"


class _Call:
    """A ``!new:``/``!name:``/``!apply:`` node (pre-resolution)."""

    __slots__ = ("path", "value", "mode")

    def __init__(self, path: str, value: Any, mode: str):
        self.path = path
        self.value = value  # mapping / sequence / scalar payload
        self.mode = mode  # "new" | "name" | "apply"

    def __repr__(self) -> str:  # pragma: no cover
        return f"!{self.mode}:{self.path} {self.value!r}"


_TUPLE_RE = re.compile(r"^\((?:[^,()]*,)*[^,()]*\)$")


class _Loader(yaml.SafeLoader):
    pass


def _construct_ref(loader: _Loader, node: yaml.Node) -> _Ref:
    return _Ref(loader.construct_scalar(node))


def _construct_copy(loader: _Loader, node: yaml.Node) -> _Ref:
    return _Ref(loader.construct_scalar(node), deep_copy=True)


def _construct_placeholder(loader: _Loader, node: yaml.Node) -> Placeholder:
    return Placeholder()


def _construct_tuple(loader: _Loader, node: yaml.Node):
    text = loader.construct_scalar(node)
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _make_call_constructor(mode: str):
    def construct(loader: _Loader, suffix: str, node: yaml.Node) -> _Call:
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_scalar(node)
            if value == "":
                value = None
        return _Call(suffix, value, mode)

    return construct


_Loader.add_constructor("!ref", _construct_ref)
_Loader.add_constructor("!copy", _construct_copy)
_Loader.add_constructor("!PLACEHOLDER", _construct_placeholder)
_Loader.add_multi_constructor("!new:", _make_call_constructor("new"))
_Loader.add_multi_constructor("!name:", _make_call_constructor("name"))
_Loader.add_multi_constructor("!apply:", _make_call_constructor("apply"))
_Loader.add_implicit_resolver("!tuple", _TUPLE_RE, first=list("("))
_Loader.add_constructor("!tuple", _construct_tuple)


_REF_TOKEN_RE = re.compile(r"<([^<>]*)>")
_ARITH_RE = re.compile(r"^[\d\s.+\-*/()eE%]+$")

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
    ast.USub: operator.neg,
    ast.UAdd: operator.pos,
}


def _safe_arith(text: str) -> Any:
    """Evaluate a pure-arithmetic expression without ``eval``."""

    def ev(node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.operand))
        raise HyperYamlError(f"unsupported arithmetic in !ref: {text!r}")

    return ev(ast.parse(text, mode="eval"))


class _Resolver:
    """Resolves the raw node tree into live objects with shared identity."""

    def __init__(self, tree: Dict[str, Any]):
        self.tree = tree
        self._cache: Dict[int, Any] = {}
        self._resolving: set = set()

    def resolve_all(self) -> Dict[str, Any]:
        out = {}
        for key in self.tree:
            out[key] = self.resolve(self.tree[key], key_name=key)
        return out

    def resolve(self, node: Any, key_name: Optional[str] = None) -> Any:
        node_id = id(node)
        if node_id in self._cache:
            return self._cache[node_id]
        if isinstance(node, (dict, list, _Call, _Ref)):
            if node_id in self._resolving:
                raise HyperYamlError(
                    f"circular !ref involving key {key_name!r}"
                )
            self._resolving.add(node_id)
        try:
            value = self._resolve_inner(node, key_name)
        finally:
            self._resolving.discard(node_id)
        if isinstance(node, (dict, list, _Call)):
            self._cache[node_id] = value
        return value

    def _resolve_inner(self, node: Any, key_name: Optional[str]) -> Any:
        if isinstance(node, Placeholder):
            raise HyperYamlError(
                f"'{key_name}' is a !PLACEHOLDER and must be overridden "
                f"(pass --{key_name}=... or an overrides entry)"
            )
        if isinstance(node, _Ref):
            value = self._resolve_ref(node.expr)
            return copy.deepcopy(value) if node.deep_copy else value
        if isinstance(node, _Call):
            return self._resolve_call(node)
        if isinstance(node, dict):
            return {k: self.resolve(v, key_name=str(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [self.resolve(v, key_name=key_name) for v in node]
        return node

    # -- !ref ---------------------------------------------------------------
    def _lookup(self, path: str) -> Any:
        parts = re.split(r"[.\[]", path)
        node: Any = self.tree
        for raw in parts:
            part = raw.rstrip("]")
            if isinstance(node, dict):
                if part not in node:
                    raise HyperYamlError(f"!ref to unknown key {path!r}")
                node = node[part]
            elif isinstance(node, (list, tuple)):
                node = node[int(part)]
            else:
                raise HyperYamlError(f"cannot index into {type(node)} for {path!r}")
        return self.resolve(node, key_name=path)

    def _resolve_ref(self, expr: str) -> Any:
        tokens = _REF_TOKEN_RE.findall(expr)
        if not tokens:
            return expr
        stripped = _REF_TOKEN_RE.sub("", expr).strip()
        if len(tokens) == 1 and stripped == "":
            return self._lookup(tokens[0])

        # Substitution: several refs and/or surrounding text.
        values = [self._lookup(t) for t in tokens]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values):
            substituted = expr
            for t, v in zip(tokens, values):
                substituted = substituted.replace(f"<{t}>", repr(v), 1)
            if _ARITH_RE.match(substituted):
                return _safe_arith(substituted)
        substituted = expr
        for t, v in zip(tokens, values):
            substituted = substituted.replace(f"<{t}>", str(v), 1)
        return substituted

    # -- !new / !name / !apply ---------------------------------------------
    def _resolve_call(self, node: _Call) -> Any:
        fn = registry.resolve_symbol(node.path)
        payload = self.resolve(node.value) if node.value is not None else None
        args: Iterable[Any] = ()
        kwargs: Dict[str, Any] = {}
        if isinstance(payload, dict):
            kwargs = payload
        elif isinstance(payload, (list, tuple)):
            args = payload
        elif payload is not None:
            args = (payload,)

        if node.mode == "name":
            if not args and not kwargs:
                return fn
            return functools.partial(fn, *args, **kwargs)
        return fn(*args, **kwargs)


def _parse_override_value(text: str) -> Any:
    """Parse a single ``--key=value`` override with yaml semantics."""
    try:
        return yaml.load(text, Loader=_Loader)
    except yaml.YAMLError:
        return text


def _apply_overrides(tree: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    for key, value in overrides.items():
        if isinstance(value, str):
            value = _parse_override_value(value)
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value


def load_hyperpyyaml(
    stream,
    overrides: Optional[Any] = None,
    overrides_must_match: bool = True,
) -> Dict[str, Any]:
    """Load a HyperPyYAML document, apply overrides, resolve all tags.

    ``overrides`` may be a dict (``{"key": value_or_yaml_str}``) or a YAML
    string (as produced by the CLI parser) — both forms match the reference
    API (``hyperpyyaml.load_hyperpyyaml``).
    """
    if hasattr(stream, "read"):
        text = stream.read()
    else:
        text = stream
    tree = yaml.load(text, Loader=_Loader)
    if tree is None:
        tree = {}
    if not isinstance(tree, dict):
        raise HyperYamlError("top-level YAML must be a mapping")

    if overrides:
        if isinstance(overrides, str):
            overrides = yaml.load(overrides, Loader=_Loader) or {}
        if overrides_must_match:
            unknown = [k for k in overrides if k.split(".")[0] not in tree]
            if unknown:
                raise HyperYamlError(
                    f"overrides refer to unknown keys: {unknown}"
                )
        _apply_overrides(tree, overrides)

    return _Resolver(tree).resolve_all()


def dump_resolved_yaml(hparams: Dict[str, Any], path: str) -> None:
    """Persist the scalar subset of resolved hparams for experiment records.

    (The reference greps values back out of saved ``hyperparams.yaml`` —
    ``evaluations/vad_shas/run_inference.sh:27-37``; we save a clean,
    reloadable scalar snapshot instead.)
    """
    scalars = {
        k: v
        for k, v in hparams.items()
        if isinstance(v, (int, float, str, bool, type(None), list, tuple))
        and not k.startswith("__")
    }
    with open(path, "w") as f:
        yaml.safe_dump(scalars, f, default_flow_style=False, sort_keys=False)
