"""Checkpoint / resume for fields and solver state (counterpart of
``stormx/io/checkpoint.py``).

Any tree of tensors, arrays and numbers (dicts, lists, tuples, named
tuples; ``None`` is an empty node) round-trips through a directory
checkpoint ``step_<step>/`` holding ``tree.npz`` and ``stormx_meta.json``,
keyed by step and stamped with the partition layout, in the JAX package's
layout.  Leaves are flattened in ``jax.tree_util``'s order — dict keys
SORTED, not in insertion order as ``torch.utils._pytree`` keeps them — so a
checkpoint written by either package loads in the other with the same
leaves.  Loads return NumPy leaves, as the JAX package's do.

The JAX package's ``orbax`` backend imports JAX, so this package refuses
it (``StormError``); ``npz`` is the one backend.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from stormx_torch.core.exceptions import StormError
from stormx_torch.sparse.formats import host

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "Checkpointer"]

_META = "stormx_meta.json"
_ORBAX = "the orbax backend imports JAX, which stormx_torch does not use; use backend='npz'"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> tuple[list, str]:
    """Leaves in ``jax.tree_util.tree_flatten``'s order, and the structure
    in its ``str(treedef)`` spelling."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, desc = _flatten(tree[key])
            leaves += sub
            parts.append(f"{key!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for item in tree:
            sub, desc = _flatten(item)
            leaves += sub
            parts.append(desc)
        if _is_namedtuple(tree):
            return leaves, f"CustomNode(namedtuple[{type(tree).__name__}], [{', '.join(parts)}])"
        if isinstance(tree, list):
            return leaves, "[" + ", ".join(parts) + "]"
        return leaves, "(" + ", ".join(parts) + (",)" if len(parts) == 1 else ")")
    return [tree], "*"


def _unflatten(like, leaves: list, pos: int = 0):
    """Rebuild ``like``'s structure from ``leaves`` (in :func:`_flatten`'s
    order); returns (tree, next position)."""
    if like is None:
        return None, pos
    if isinstance(like, dict):
        vals = {}
        for key in sorted(like):
            vals[key], pos = _unflatten(like[key], leaves, pos)
        return {key: vals[key] for key in like}, pos
    if isinstance(like, (list, tuple)):
        items = []
        for item in like:
            sub, pos = _unflatten(item, leaves, pos)
            items.append(sub)
        if _is_namedtuple(like):
            return type(like)(*items), pos
        return type(like)(items), pos
    return leaves[pos], pos + 1



def _layout_signature(num_parts: int | None) -> dict:
    devices = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "num_parts": num_parts,
        "num_devices": devices if num_parts is None else num_parts,
    }


def save_checkpoint(directory: str, step: int, state, *, num_parts: int | None = None,
                    backend: str = "npz") -> str:
    """Write ``state`` under ``directory/step_<step>``; returns the path."""
    if backend == "orbax":
        raise StormError(_ORBAX)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    path = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(path, exist_ok=True)
    leaves, treedef = _flatten(state)
    meta = {
        "step": step,
        "treedef": f"PyTreeDef({treedef})",
        "num_leaves": len(leaves),
        "layout": _layout_signature(num_parts),
        "backend": backend,
    }
    np.savez(
        os.path.join(path, "tree.npz"),
        **{f"leaf_{i}": host(leaf) for i, leaf in enumerate(leaves)},
    )
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(directory: str, step: int | None = None, *, like=None,
                    num_parts: int | None = None):
    """Load the checkpoint at ``step`` (default latest) as NumPy leaves.

    ``like``: a tree with the target structure; the stored leaves are
    unflattened into it.  Without it, the flat leaf list is returned.
    Raises if the stored partition layout differs from ``num_parts``
    (pass the current layout to get the mismatch check).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if num_parts is not None and meta["layout"]["num_parts"] not in (None, num_parts):
        raise ValueError(
            f"checkpoint was written with num_parts={meta['layout']['num_parts']}, "
            f"resume requested num_parts={num_parts}; repartition explicitly"
        )
    if meta["backend"] == "orbax":
        raise StormError(_ORBAX)
    with np.load(os.path.join(path, "tree.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    if like is not None:
        return _unflatten(like, leaves)[0], meta["step"]
    return leaves, meta["step"]


def _steps(directory: str) -> list[int]:
    return [
        int(m.group(1))
        for name in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", name))
    ]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


class Checkpointer:
    """Periodic checkpointing helper for time loops.

    >>> ck = Checkpointer("ckpts", every=100)
    >>> for step in range(start, end):
    ...     state = advance(state)
    ...     ck.maybe_save(step, state)
    """

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3,
                 num_parts: int | None = None, backend: str = "npz"):
        if backend == "orbax":
            raise StormError(_ORBAX)
        self.directory = directory
        self.every = every
        self.keep = keep
        self.num_parts = num_parts
        self.backend = backend

    def maybe_save(self, step: int, state) -> str | None:
        if step % self.every:
            return None
        path = save_checkpoint(self.directory, step, state, num_parts=self.num_parts,
                               backend=self.backend)
        self._prune()
        return path

    def restore(self, like=None):
        return load_checkpoint(self.directory, like=like, num_parts=self.num_parts)

    def _prune(self) -> None:
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)
