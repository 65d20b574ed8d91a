"""Binary composition tree for parameters.

PyTorch port of ``composablestatespacemodels_tpu/models/tree.py``
(reference: Tree.scala:12-108).  A composed model's parameters form a
binary tree whose shape matches the model composition:
``branch(leaf(p1), leaf(p2))`` parameterises ``m1 + m2``.  Without JAX
there is no pytree registration; the tree is plain Python objects holding
tensors, and :meth:`Tree.map` moves or converts the leaves.
"""

from __future__ import annotations

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


def leaf(value) -> Leaf:
    return Leaf(value)


def branch(left: Tree, right: Tree) -> Branch:
    return Branch(left, right)
