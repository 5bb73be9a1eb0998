"""Checkpointing: timed/top-k saves, retention by metric, model averaging
(port of ``stac_st_tpu/training/checkpoint.py``).

The SpeechBrain Checkpointer semantics the reference relies on
(``transformer_multitask.yaml:272-278``, ``train_multitask.py:420-424`` and
``:460-471``): end-of-validation saves keeping the top-``num_to_keep`` by a
max-key metric (ACC), and ``average_checkpoints`` over the kept set at
evaluation start.

Storage is the JAX package's, byte for byte: one directory per checkpoint
(``CKPT+<stamp>[+NN]``) holding ``meta.json`` and one ``<name>.msgpack``
per tree, in flax's msgpack encoding (``flax.serialization.
msgpack_serialize``), written here with ``msgpack`` itself:

* a tree is nested dicts, keys sorted at every level (flax copies the tree
  through ``jax.tree_util``, which sorts dict keys); a list or tuple
  becomes a dict keyed ``"0"``, ``"1"``, ... as ``to_state_dict`` makes it;
* an array leaf (numpy, or a tensor, moved to the host) is ext type 1
  holding the msgpack of ``(shape, dtype name, C-order bytes)``; a numpy
  scalar is ext type 3 with the same payload (read back as a scalar);
  Python scalars are plain msgpack, packed with ``strict_types``.

flax splits an array over 2**30 bytes into chunks; no model of the
repository has one (the flagship's largest leaf is 5 MB), so writing one
raises here instead.

So each package loads the other's checkpoints (the trees they share are
listed in ``training.trainer``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import msgpack
import numpy as np
import torch

__all__ = ["Checkpoint", "Checkpointer", "average_checkpoints",
           "msgpack_serialize", "msgpack_restore"]

# flax.serialization's ext type codes
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_LEAF_BYTES = 2 ** 30


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("a bfloat16 leaf: the port's checkpoints hold fp32")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(x)))
    return x


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _host_tree(tree: Any) -> Any:
    """The tree as flax writes it: dicts with sorted string keys, host
    arrays."""
    if isinstance(tree, dict):
        return {str(k): _host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _host_tree(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"a {tree.nbytes}-byte leaf: flax would chunk it")
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives the same
    tree (tensors count as their host arrays)."""
    return msgpack.packb(_host_tree(tree), default=_ext_pack,
                         strict_types=True)


def msgpack_restore(data: bytes) -> Any:
    """Nested dicts of numpy arrays and Python scalars, as
    ``flax.serialization.msgpack_restore`` gives them."""
    return msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False)


class Checkpoint:
    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, "meta.json")
        with open(meta_path) as f:
            self.meta: Dict[str, Any] = json.load(f)

    def load(self, name: str):
        fpath = os.path.join(self.path, f"{name}.msgpack")
        with open(fpath, "rb") as f:
            return msgpack_restore(f.read())

    def names(self) -> List[str]:
        return [
            f[:-8]
            for f in os.listdir(self.path)
            if f.endswith(".msgpack")
        ]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Checkpoint({self.path!r})"


class Checkpointer:
    def __init__(
        self,
        checkpoints_dir: str,
        recoverables: Optional[Dict[str, Any]] = None,
        **unused,
    ):
        self.checkpoints_dir = checkpoints_dir
        # YAML-declared recoverables (objects); the trainer supplies the
        # actual trees at save time keyed by the same names.
        self.recoverables = recoverables or {}
        os.makedirs(checkpoints_dir, exist_ok=True)

    # ------------------------------------------------------------------ IO
    def _new_dir(self) -> str:
        stamp = time.strftime("%Y-%m-%d+%H-%M-%S")
        path = os.path.join(self.checkpoints_dir, f"CKPT+{stamp}")
        suffix = 0
        final = path
        while os.path.exists(final):
            suffix += 1
            final = f"{path}+{suffix:02d}"
        os.makedirs(final)
        return final

    def save_checkpoint(
        self, meta: Dict[str, Any], trees: Dict[str, Any]
    ) -> Checkpoint:
        path = self._new_dir()
        for name, tree in trees.items():
            with open(os.path.join(path, f"{name}.msgpack"), "wb") as f:
                f.write(msgpack_serialize(tree))
        meta = dict(meta)
        meta.setdefault("unixtime", time.time())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=float)
        return Checkpoint(path)

    def list_checkpoints(self) -> List[Checkpoint]:
        out = []
        for entry in sorted(os.listdir(self.checkpoints_dir)):
            full = os.path.join(self.checkpoints_dir, entry)
            if entry.startswith("CKPT") and os.path.isdir(full):
                if os.path.isfile(os.path.join(full, "meta.json")):
                    out.append(Checkpoint(full))
        return out

    def find_checkpoints(
        self,
        max_key: Optional[str] = None,
        min_key: Optional[str] = None,
        max_num_checkpoints: Optional[int] = None,
    ) -> List[Checkpoint]:
        ckpts = self.list_checkpoints()
        if max_key:
            ckpts = [c for c in ckpts if max_key in c.meta]
            ckpts.sort(key=lambda c: c.meta[max_key], reverse=True)
        elif min_key:
            ckpts = [c for c in ckpts if min_key in c.meta]
            ckpts.sort(key=lambda c: c.meta[min_key])
        else:
            ckpts.sort(key=lambda c: c.meta.get("unixtime", 0), reverse=True)
        if max_num_checkpoints is not None:
            ckpts = ckpts[:max_num_checkpoints]
        return ckpts

    def recover_if_possible(
        self, max_key: Optional[str] = None
    ) -> Optional[Checkpoint]:
        ckpts = self.find_checkpoints(max_key=max_key)
        return ckpts[0] if ckpts else None

    # ------------------------------------------------------------ retention
    def save_and_keep_only(
        self,
        meta: Dict[str, Any],
        trees: Dict[str, Any],
        max_keys: Optional[List[str]] = None,
        num_to_keep: int = 5,
    ) -> Checkpoint:
        ckpt = self.save_checkpoint(meta, trees)
        key = (max_keys or ["unixtime"])[0]
        ckpts = [c for c in self.list_checkpoints() if key in c.meta]
        ckpts.sort(key=lambda c: c.meta[key], reverse=True)
        for old in ckpts[num_to_keep:]:
            shutil.rmtree(old.path, ignore_errors=True)
        return ckpt


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """``jax.tree_util.tree_map`` over nested dicts: the same keys in
    every tree, sorted in the result."""
    if isinstance(trees[0], dict):
        keys = sorted(trees[0])
        for t in trees[1:]:
            if not isinstance(t, dict) or sorted(t) != keys:
                raise ValueError("checkpoint trees differ in structure")
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in keys}
    return fn(*trees)


def average_checkpoints(
    checkpoints: List[Checkpoint], recoverable_name: str = "model",
    **unused,
) -> Any:
    """Arithmetic mean of a recoverable tree across checkpoints, summed in
    float64 and cast back to each leaf's dtype (reference
    ``sb.utils.checkpoints.average_checkpoints``,
    ``train_multitask.py:465-467``)."""
    if not checkpoints:
        raise ValueError("no checkpoints to average")
    trees = [c.load(recoverable_name) for c in checkpoints]
    n = float(len(trees))

    def mean(*leaves):
        stacked = np.stack([np.asarray(l, np.float64) for l in leaves])
        return (stacked.sum(0) / n).astype(np.asarray(leaves[0]).dtype)

    return _tree_map(mean, *trees)
