"""Binary composition tree for parameters.

PyTorch port of ``composablestatespacemodels_tpu/models/tree.py``
(reference: Tree.scala:12-108).  A composed model's parameters form a
binary tree whose shape matches the model composition:
``branch(leaf(p1), leaf(p2))`` parameterises ``m1 + m2``.  Without JAX
there is no pytree registration; the tree is plain Python objects with
the reference's algebra: ``map``, ``zip_with``, ``fold``, ``flat_map``,
``traverse``, ``concat`` (``+++``) and leafwise ``+``, and structural
equality and hashing by value.
:func:`tree_map` maps a function over the tensors of one or more trees of
the same structure (the ``jax.tree_util.tree_map`` of the JAX package):
PMMH's select of proposed against current parameters, and the stacking of
a chain's draws.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable

import numpy as np
import torch


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

    def get_node(self, n: int):
        """n-th leaf value counting from 0 on the left.  Reference:
        Tree.scala:26-29."""
        return self.flatten()[n]

    def n_leaves(self) -> int:
        return len(self.flatten())

    def map(self, f: Callable[[Any], Any]) -> "Tree":
        if isinstance(self, Leaf):
            return Leaf(f(self.value))
        if isinstance(self, Branch):
            return Branch(self.left.map(f), self.right.map(f))
        return self

    def zip_with(self, other: "Tree", f: Callable[[Any, Any], Any]) -> "Tree":
        """Shape-checked leafwise combination.  Reference: Tree.scala:58-62."""
        if isinstance(self, Leaf) and isinstance(other, Leaf):
            return Leaf(f(self.value, other.value))
        if isinstance(self, Branch) and isinstance(other, Branch):
            return Branch(self.left.zip_with(other.left, f),
                          self.right.zip_with(other.right, f))
        if isinstance(self, EmptyTree) and isinstance(other, EmptyTree):
            return self
        raise ValueError(f"Tree shapes do not match: {type(self).__name__} "
                         f"vs {type(other).__name__}")

    def fold(self, zero, f: Callable[[Any], Any],
             combine: Callable[[Any, Any], Any]):
        """Fold over leaves.  Reference: Tree.scala:35-43."""
        if isinstance(self, Leaf):
            return f(self.value)
        if isinstance(self, Branch):
            return combine(self.left.fold(zero, f, combine),
                           self.right.fold(zero, f, combine))
        return zero

    def flat_map(self, f: Callable[[Any], "Tree"]) -> "Tree":
        """Each leaf replaced by the tree ``f(value)``: the ``Monad[Tree]``
        instance's ``flatMap`` (Tree.scala:115-137)."""
        if isinstance(self, Leaf):
            return f(self.value)
        if isinstance(self, Branch):
            return Branch(self.left.flat_map(f), self.right.flat_map(f))
        return self

    def traverse(self, f: Callable[[Any], Any]) -> Any:
        """Effectful map (Tree.traverse, Tree.scala:87-91): ``f`` returning
        a value maps; ``f`` returning None makes the whole result None (the
        reference's ``Option``); ``f`` raising fails fast (its ``Try``)."""
        if isinstance(self, Leaf):
            v = f(self.value)
            return None if v is None else Leaf(v)
        if isinstance(self, Branch):
            left = self.left.traverse(f)
            if left is None:
                return None
            right = self.right.traverse(f)
            if right is None:
                return None
            return Branch(left, right)
        return self

    def concat(self, other: "Tree") -> "Tree":
        """``+++``: ``other`` grafted as the right child, Empty the
        identity.  Reference: Tree.scala:18-20."""
        if isinstance(self, EmptyTree):
            return other
        if isinstance(other, EmptyTree):
            return self
        return Branch(self, other)

    def __add__(self, other: "Tree") -> "Tree":
        """Leafwise addition of identically shaped trees (Tree.scala:103-104);
        parameter records are added field by field."""
        return self.zip_with(other,
                             lambda a, b: tree_map(operator.add, a, b))

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

    def __eq__(self, other):
        return isinstance(other, Leaf) and _eq(self.value, other.value)

    def __hash__(self):
        # not cached: a tensor leaf can change in place
        return hash(("Leaf", _hash_value(self.value)))


class Branch(Tree):
    __slots__ = ("left", "right")

    def __init__(self, left: Tree, right: Tree):
        self.left = left
        self.right = right

    def __repr__(self):
        return f"Branch({self.left!r}, {self.right!r})"

    def __eq__(self, other):
        return (isinstance(other, Branch) and self.left == other.left
                and self.right == other.right)

    def __hash__(self):
        return hash(("Branch", self.left, self.right))


class EmptyTree(Tree):
    """The empty tree (no parameters); ``Empty`` is its one instance."""

    __slots__ = ()

    def __repr__(self):
        return "Empty"

    def __eq__(self, other):
        return isinstance(other, EmptyTree)

    def __hash__(self):
        return hash("EmptyTree")


Empty = EmptyTree()


def _is_record(v) -> bool:
    return dataclasses.is_dataclass(v) and not isinstance(v, type)


def _host64(v) -> torch.Tensor:
    """``v`` as a float64 (complex128) tensor on the host: the value that
    equality and hashing compare, whatever the dtype and device."""
    t = (v.detach().cpu() if isinstance(v, torch.Tensor)
         else torch.as_tensor(np.asarray(v)))
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _eq(a, b) -> bool:
    """Value equality of leaves: the same shape and equal elements,
    whatever the dtype or device (``1.0`` equals ``torch.tensor(1.0)``).
    No broadcasting: ``ones(3)`` and ``1.0`` are different leaves.
    Parameter records compare field by field; None equals only None."""
    if _is_record(a) or _is_record(b):
        return type(a) is type(b) and all(
            _eq(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if a is None or b is None:
        return a is b
    try:
        ta, tb = _host64(a), _host64(b)
    except (TypeError, ValueError, RuntimeError):
        return a == b
    return ta.shape == tb.shape and bool(torch.equal(ta, tb))


def _hash_value(v) -> int:
    """Hash consistent with :func:`_eq`: a numeric value hashes its shape
    and float64 bytes (``+ 0.0`` folds -0.0 into 0.0), a record its
    fields, anything else its own hash (0 when unhashable)."""
    if _is_record(v):
        return hash((type(v).__name__, tuple(
            _hash_value(getattr(v, f.name)) for f in dataclasses.fields(v))))
    try:
        t = _host64(v) + 0.0
    except (TypeError, ValueError, RuntimeError):
        try:
            return hash(v)
        except TypeError:
            return 0
    return hash((tuple(t.shape), t.numpy().tobytes()))


def tree_map(f: Callable, tree, *rest):
    """``f`` applied to the corresponding tensors of ``tree`` and ``rest``,
    which share its structure: :class:`Tree` nodes, tuples and lists,
    dataclasses (parameter records) and tensors; None stays None."""
    if tree is None or isinstance(tree, EmptyTree):
        return tree
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


def construct_tree_left(values) -> Tree:
    """A left-nested tree of ``values`` in order (Empty for none).
    Reference: Tree.scala:143-145 (``constructTreeLeft``)."""
    values = list(values)
    if not values:
        return Empty
    t: Tree = Leaf(values[0])
    for v in values[1:]:
        t = Branch(t, Leaf(v))
    return t
