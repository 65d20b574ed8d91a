"""The port's tree algebra (Tree.scala): the property tests of
tests/test_tree_properties.py on composablestatespacemodels_torch's
tree, with the same numpy generators, then the port held to the JAX
tree leaf by leaf on trees built from the same numpy values, and ``==``
and ``hash`` giving the same answers in both packages pair by pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch.models as tm
import composablestatespacemodels_tpu.models as jm
from composablestatespacemodels_torch.models import tree as tt
from composablestatespacemodels_torch.models.params import (add_flat,
                                                            flatten_params,
                                                            ou_params,
                                                            param_node)
from composablestatespacemodels_torch.models.tree import (EmptyTree, Leaf,
                                                          Tree, branch,
                                                          construct_tree_left,
                                                          leaf)
from composablestatespacemodels_tpu.models import tree as jt

RNG = np.random.default_rng(7)


def random_tree(depth: int = 0) -> Tree:
    """Random tree of float leaves, geometric-ish in depth (<= 6)."""
    r = RNG.random()
    if depth >= 6 or r < 0.4:
        return leaf(float(RNG.normal()))
    if r < 0.45 and depth > 0:
        return EmptyTree()
    return branch(random_tree(depth + 1), random_tree(depth + 1))


def random_param_tree(depth: int = 0) -> Tree:
    if depth >= 3 or RNG.random() < 0.5:
        vals = RNG.normal(size=5)
        return leaf(param_node(float(RNG.normal()), ou_params(*vals)))
    return branch(random_param_tree(depth + 1), random_param_tree(depth + 1))


@pytest.mark.parametrize("trial", range(25))
def test_concat_monoid_laws(trial):
    """concat (Tree.scala:154-157): associative, Empty the identity, up to
    flatten order (the reference's Eq, Tree.scala:163-167)."""
    a, b, c = random_tree(), random_tree(), random_tree()
    assert a.concat(b).concat(c).flatten() == a.concat(b.concat(c)).flatten()
    e = EmptyTree()
    assert e.concat(a).flatten() == a.flatten()
    assert a.concat(e).flatten() == a.flatten()


@pytest.mark.parametrize("trial", range(25))
def test_map_functor_laws(trial):
    t = random_tree()
    assert t.map(lambda x: x).flatten() == t.flatten()
    f = lambda x: x * 2.0
    g = lambda x: x + 1.0
    assert t.map(lambda x: g(f(x))).flatten() == t.map(f).map(g).flatten()


@pytest.mark.parametrize("trial", range(25))
def test_zip_with_plus_commutes(trial):
    """Leafwise plus commutes (ParameterTest.scala:62-68)."""
    t = random_tree()
    u = t.map(lambda x: float(RNG.normal()))
    ab = t.zip_with(u, lambda a, b: a + b).flatten()
    ba = u.zip_with(t, lambda a, b: a + b).flatten()
    np.testing.assert_allclose(ab, ba)
    assert (t + u).flatten() == ab


def test_zip_with_shape_mismatch_raises():
    with pytest.raises(ValueError):
        branch(leaf(1.0), leaf(2.0)).zip_with(leaf(3.0), lambda x, y: x + y)


@pytest.mark.parametrize("trial", range(10))
def test_construct_tree_left_preserves_order(trial):
    n = int(RNG.integers(1, 12))
    vals = [float(v) for v in RNG.normal(size=n)]
    t = construct_tree_left(vals)
    assert t.flatten() == vals
    assert t.n_leaves() == n
    for i in range(n):
        assert t.get_node(i) == vals[i]


@pytest.mark.parametrize("trial", range(10))
def test_fold_agrees_with_flatten(trial):
    t = random_tree()
    total = t.fold(0.0, lambda x: x, lambda a, b: a + b)
    np.testing.assert_allclose(total, sum(t.flatten()), rtol=1e-12)


@pytest.mark.parametrize("trial", range(10))
def test_add_flat_is_translation(trial):
    """Addable: adding a flat vector then flattening == flattening then
    adding (ParameterTest.scala:70-76), on the port's ``add_flat``."""
    p = random_param_tree()
    flat = flatten_params(p)
    delta = torch.from_numpy(RNG.normal(size=flat.shape[0]).astype(np.float32))
    np.testing.assert_allclose(flatten_params(add_flat(p, delta)).numpy(),
                               (flat + delta).numpy(), rtol=1e-5, atol=1e-6)


# -- monadic ops (Tree.scala:87-91, 115-137) --------------------------------


def test_flat_map_left_identity():
    f = lambda v: branch(leaf(v), leaf(v + 1))
    assert leaf(3).flat_map(f) == f(3)


def test_flat_map_right_identity_random_trees():
    for _ in range(10):
        t = random_tree()
        assert t.flat_map(leaf) == t


def test_flat_map_associativity():
    f = lambda v: branch(leaf(v), leaf(-v))
    g = lambda v: leaf(v * 2)
    for _ in range(5):
        t = random_tree()
        assert t.flat_map(f).flat_map(g) == t.flat_map(
            lambda v: f(v).flat_map(g))


def test_traverse_plain_map_equivalence():
    t = branch(leaf(1.0), branch(leaf(2.0), leaf(3.0)))
    assert t.traverse(lambda v: v + 1) == t.map(lambda v: v + 1)


def test_traverse_none_propagates():
    t = branch(leaf(1.0), branch(leaf(-2.0), leaf(3.0)))
    assert t.traverse(lambda v: v if v > 0 else None) is None
    assert t.traverse(lambda v: v) == t


def test_traverse_fail_fast():
    t = branch(leaf(1.0), leaf(-1.0))

    def f(v):
        if v < 0:
            raise ValueError("neg")
        return v

    with pytest.raises(ValueError, match="neg"):
        t.traverse(f)


# -- the port against the JAX tree, on trees of the same numpy values --------

PARITY_RNG = np.random.default_rng(20261017)


def random_shape(depth: int = 0):
    """A tree as nested tuples of float32 vectors of length 1-3 (None for
    Empty), for building the same tree in both packages."""
    r = PARITY_RNG.random()
    if depth >= 5 or r < 0.4:
        return PARITY_RNG.normal(size=int(PARITY_RNG.integers(1, 4))).astype(
            np.float32)
    if r < 0.45 and depth > 0:
        return None
    return (random_shape(depth + 1), random_shape(depth + 1))


def build(mod, shape, to_leaf):
    if shape is None:
        return mod.EmptyTree()
    if isinstance(shape, tuple):
        return mod.branch(build(mod, shape[0], to_leaf),
                          build(mod, shape[1], to_leaf))
    return mod.leaf(to_leaf(shape))


def both_trees(shape):
    return (build(jt, shape, jnp.asarray),
            build(tt, shape, torch.from_numpy))


def _same_values(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("trial", range(8))
def test_jax_parity_leafwise(trial):
    """flatten, n_leaves, get_node, structure, fold, zip_with, + and
    concat: the port's answers are the JAX tree's on the same values."""
    shape = random_shape()
    jx, tx = both_trees(shape)
    assert tx.structure() == jx.structure()
    assert tx.n_leaves() == jx.n_leaves()
    _same_values(tx.flatten(), jx.flatten())
    for i in range(jx.n_leaves()):
        np.testing.assert_array_equal(tx.get_node(i).numpy(),
                                      np.asarray(jx.get_node(i)))
    fold_args = (0.0, lambda v: v.sum(), lambda a, b: a + b)
    np.testing.assert_array_equal(np.asarray(tx.fold(*fold_args)),
                                  np.asarray(jx.fold(*fold_args)))
    jy, ty = both_trees(fresh_values(shape))
    _same_values((tx + ty).flatten(), (jx + jy).flatten())
    _same_values(tx.zip_with(ty, lambda a, b: a * b - b).flatten(),
                 jx.zip_with(jy, lambda a, b: a * b - b).flatten())
    _same_values(tx.concat(ty).flatten(), jx.concat(jy).flatten())
    assert tx.concat(ty).structure() == jx.concat(jy).structure()
    if not isinstance(jx, jt.Leaf):
        with pytest.raises(ValueError):
            jx.zip_with(jt.leaf(1.0), lambda a, b: a)
        with pytest.raises(ValueError):
            tx.zip_with(tt.leaf(1.0), lambda a, b: a)


def fresh_values(shape):
    """A shape of the same structure with fresh values."""
    if shape is None:
        return None
    if isinstance(shape, tuple):
        return tuple(fresh_values(s) for s in shape)
    return PARITY_RNG.normal(size=shape.shape).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_jax_parity_construct_tree_left(n):
    vals = PARITY_RNG.normal(size=n)
    jx = jm.construct_tree_left([float(v) for v in vals])
    tx = tt.construct_tree_left([float(v) for v in vals])
    assert tx.structure() == jx.structure()
    assert tx.flatten() == jx.flatten()
    assert tx == tt.construct_tree_left(list(vals))


def _ou(pkg, vals):
    return pkg.ou_params(*(float(v) for v in vals))


def _pn(pkg, scale, vals):
    return pkg.param_node(scale, _ou(pkg, vals))


# pairs of leaf values built in each package from the same numpy values:
# (name, make) with make(pkg, as_array) -> (x, y)
F32, F64 = np.asarray([1.0, 2.5], np.float32), np.asarray([1.0, 2.5])
OU = np.asarray([0.2, 0.3, 0.25, -0.4, 0.7])
PAIRS = [
    ("float32 vs float64 vector", lambda p, a: (p.leaf(a(F32)), p.leaf(a(F64)))),
    ("float vs float32 scalar", lambda p, a: (p.leaf(1.0),
                                              p.leaf(a(np.float32(1.0))))),
    ("int vs float", lambda p, a: (p.leaf(3), p.leaf(3.0))),
    ("float32 vs float64, different values",
     lambda p, a: (p.leaf(a(np.float32(0.1))), p.leaf(a(np.float64(0.1))))),
    ("ones(3) vs 1.0", lambda p, a: (p.leaf(a(np.ones(3))), p.leaf(1.0))),
    ("[1, 2] vs [1, 2, 0]", lambda p, a: (p.leaf(a(F64)),
                                          p.leaf(a(np.r_[F64, 0.0])))),
    ("Empty vs Empty", lambda p, a: (p.Empty, p.tree.EmptyTree())),
    ("Empty vs leaf", lambda p, a: (p.Empty, p.leaf(0.0))),
    ("branch vs equal branch", lambda p, a: (
        p.branch(p.leaf(a(F32)), p.leaf(2.0)),
        p.branch(p.leaf(a(F64)), p.leaf(a(np.float32(2.0)))))),
    ("branch vs swapped branch", lambda p, a: (
        p.branch(p.leaf(1.0), p.leaf(2.0)), p.branch(p.leaf(2.0),
                                                     p.leaf(1.0)))),
    ("ParamNode None scale vs None scale", lambda p, a: (
        p.leaf(_pn(p, None, OU)), p.leaf(_pn(p, None, OU)))),
    ("ParamNode None scale vs float scale", lambda p, a: (
        p.leaf(_pn(p, None, OU)), p.leaf(_pn(p, 0.5, OU)))),
    ("ParamNode float scale vs float scale", lambda p, a: (
        p.leaf(_pn(p, 0.5, OU)), p.leaf(_pn(p, 0.5, OU)))),
    ("ParamNode different field", lambda p, a: (
        p.leaf(_pn(p, 0.5, OU)), p.leaf(_pn(p, 0.5, OU + [0, 0, 0, 0, 1e-3])))),
    ("ParamNode different scale", lambda p, a: (
        p.leaf(_pn(p, 0.5, OU)), p.leaf(_pn(p, 0.25, OU)))),
]


@pytest.mark.parametrize("name,make", PAIRS, ids=[p[0] for p in PAIRS])
def test_eq_hash_agree_with_jax(name, make):
    """``==`` and ``hash`` give the same answers in both packages, pair by
    pair, and equal trees hash equally (the hash/eq contract).  The JAX
    leaves hold the numpy values themselves (``jnp.asarray`` would round a
    float64 to float32), the port's their tensors."""
    jx, jy = make(jm, np.asarray)
    tx, ty = make(tm, torch.as_tensor)
    assert (tx == ty) == (jx == jy)
    assert (tx != ty) == (jx != jy)
    assert (hash(tx) == hash(ty)) == (hash(jx) == hash(jy))
    if tx == ty:
        assert {tx: 1}[ty] == 1
    assert tx == tx and hash(tx) == hash(tx)


def test_leaf_equality_follows_values():
    """Equality across dtypes and devices' host copies, no broadcasting,
    and no cached hash: a leaf changed in place hashes anew."""
    assert Leaf(1.0) == Leaf(torch.tensor(1.0))
    assert hash(Leaf(1.0)) == hash(Leaf(torch.tensor(1.0)))
    assert Leaf(torch.ones(3)) != Leaf(1.0)
    assert Leaf(-0.0) == Leaf(0.0) and hash(Leaf(-0.0)) == hash(Leaf(0.0))
    v = torch.zeros(2)
    t = Leaf(v)
    h0 = hash(t)
    v[0] = 1.0
    assert t != Leaf(torch.zeros(2)) and hash(t) != h0


def test_add_params_fieldwise():
    """``+`` on parameter trees adds the records field by field, a None
    scale staying None."""
    p = branch(leaf(param_node(None, ou_params(*OU))),
               leaf(param_node(0.5, ou_params(*OU))))
    doubled = p.map(lambda v: tt.tree_map(lambda x: 2 * x, v))
    assert p + p == doubled
    assert (p + p).get_node(0).scale is None
    assert p + p != p
