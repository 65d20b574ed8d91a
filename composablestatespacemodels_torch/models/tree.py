"""Binary composition tree for parameters.

PyTorch port of ``composablestatespacemodels_tpu/models/tree.py``
(reference: Tree.scala:12-108).  A composed model's parameters form a
binary tree whose shape matches the model composition:
``branch(leaf(p1), leaf(p2))`` parameterises ``m1 + m2``.  Without JAX
there is no pytree registration; the tree is plain Python objects, and
:meth:`Tree.map` maps a function over its leaf values.
:func:`tree_map` maps a function over the tensors of one or more trees of
the same structure (the ``jax.tree_util.tree_map`` of the JAX package):
PMMH's select of proposed against current parameters, and the stacking of
a chain's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


class Tree:
    """Abstract base for the composition tree."""

    __slots__ = ()

    def flatten(self) -> list:
        """Left-to-right list of leaf values.  Reference: Tree.scala:49-53."""
        if isinstance(self, Leaf):
            return [self.value]
        if isinstance(self, Branch):
            return self.left.flatten() + self.right.flatten()
        return []

    def map(self, f: Callable[[Any], Any]) -> "Tree":
        if isinstance(self, Leaf):
            return Leaf(f(self.value))
        if isinstance(self, Branch):
            return Branch(self.left.map(f), self.right.map(f))
        return self

    def structure(self) -> Any:
        """Shape signature, comparable with ``Model.structure()``."""
        if isinstance(self, Leaf):
            return "L"
        if isinstance(self, Branch):
            return (self.left.structure(), self.right.structure())
        return "E"


class Leaf(Tree):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return f"Leaf({self.value!r})"


class Branch(Tree):
    __slots__ = ("left", "right")

    def __init__(self, left: Tree, right: Tree):
        self.left = left
        self.right = right

    def __repr__(self):
        return f"Branch({self.left!r}, {self.right!r})"


def tree_map(f: Callable, tree, *rest):
    """``f`` applied to the corresponding tensors of ``tree`` and ``rest``,
    which share its structure: :class:`Tree` nodes, tuples and lists,
    dataclasses (parameter records) and tensors; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, Leaf):
        return Leaf(tree_map(f, tree.value, *(r.value for r in rest)))
    if isinstance(tree, Branch):
        return Branch(tree_map(f, tree.left, *(r.left for r in rest)),
                      tree_map(f, tree.right, *(r.right for r in rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            fl.name: tree_map(f, getattr(tree, fl.name),
                              *(getattr(r, fl.name) for r in rest))
            for fl in dataclasses.fields(tree)})
    return f(tree, *rest)


def leaf(value) -> Leaf:
    return Leaf(value)


def branch(left: Tree, right: Tree) -> Branch:
    return Branch(left, right)
