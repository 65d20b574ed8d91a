"""Checkpoint / resume for long-running chains and filters.

PyTorch port of ``composablestatespacemodels_tpu/utils/checkpoint.py``
(the reference serialises chain state as line-delimited JSON plus Java
object serialization, Streaming.scala:200-241).  A checkpoint is an
``np.savez`` archive of the state's leaves, ``leaf_0``, ``leaf_1``, ...,
written to a temporary file and renamed into place, with a ``.tree`` side
file that records the structure for a human reader; restore takes an
explicit template (no pickling).

The leaves are found by this module's own walk, in the order of
``jax.tree_util``'s flatten in the JAX package: a dict by sorted key,
tuples and lists in order, :class:`~..models.tree.Leaf` /
:class:`~..models.tree.Branch` and dataclasses (parameter records,
``PmmhState``, ``PmmhResult``) field by field; None and ``()`` hold no
leaf.  So a checkpoint of a parameter tree crosses between the packages
both ways.  A ``torch.Generator``'s role (the JAX key data) is played by
a base seed saved as an int64 leaf.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..models.tree import Branch, EmptyTree, Leaf
from .data import to_numpy


def _children(node):
    """``(children, rebuild)`` of an inner node, or None for a leaf."""
    if node is None or isinstance(node, EmptyTree):
        return [], lambda _: node
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(node, (tuple, list)):
        return list(node), lambda xs: type(node)(xs)
    if isinstance(node, Leaf):
        return [node.value], lambda xs: Leaf(xs[0])
    if isinstance(node, Branch):
        return [node.left, node.right], lambda xs: Branch(*xs)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return ([getattr(node, n) for n in names],
                lambda xs: dataclasses.replace(node, **dict(zip(names, xs))))
    return None


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in flatten order (see the module docstring)."""
    split = _children(tree)
    if split is None:
        return [tree]
    return [leaf for child in split[0] for leaf in tree_leaves(child)]


def tree_unflatten(template, leaves) -> Any:
    """``template``'s structure holding ``leaves`` (an iterator is consumed
    in flatten order)."""
    leaves = iter(leaves)

    def build(node):
        split = _children(node)
        if split is None:
            return next(leaves)
        children, rebuild = split
        return rebuild([build(c) for c in children])

    return build(template)


def tree_structure(tree) -> str:
    """A human-readable structure record: ``*`` for each leaf."""
    split = _children(tree)
    if split is None:
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if not split[0]:
        return repr(tree)
    inner = ", ".join(tree_structure(c) for c in split[0])
    return f"{type(tree).__name__}({inner})"


def _dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.result_type(x)


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Save a state dict of tensors, arrays, scalars, parameter trees and
    records atomically (the archive is written to a temporary file and
    renamed over ``path``)."""
    arrays = {f"leaf_{i}": to_numpy(x)
              for i, x in enumerate(tree_leaves(state))}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    with open(path + ".tree", "w") as f:
        f.write(tree_structure(state))


def restore_checkpoint(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restore into the structure of ``template``: shapes and dtypes are
    validated leaf by leaf, and each leaf comes back as a tensor on the
    device of the template's leaf (the CPU for a non-tensor leaf)."""
    leaves = []
    with np.load(path) as data:
        for i, lt in enumerate(tree_leaves(template)):
            arr = data[f"leaf_{i}"]
            want = tuple(lt.shape) if isinstance(lt, torch.Tensor) \
                else np.shape(lt)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != template "
                    f"{want}")
            if arr.dtype != _dtype(lt):
                raise ValueError(
                    f"checkpoint leaf {i} dtype {arr.dtype} != template "
                    f"{_dtype(lt)}")
            device = lt.device if isinstance(lt, torch.Tensor) else "cpu"
            leaves.append(torch.from_numpy(arr).to(device))
    return tree_unflatten(template, leaves)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path)
