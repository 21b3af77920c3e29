"""Minimal pytree ("nest") helpers over dict / list / tuple / leaf structures.

Counterpart of the reference's ``examples/common/nest.py:4-41`` and the C++
``utils::stackFields/unstackFields`` family (``src/batch_utils.h:21-27``).
Leaves are torch tensors, numpy arrays or python scalars.  Only
dict/list/tuple containers are supported — matching the wire format of the
RPC layer — so a nest serialized on one peer reassembles identically on
another.
"""

from __future__ import annotations

from builtins import zip as _zip
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

Nest = Any  # dict / list / tuple / leaf


def map(f: Callable, n: Nest) -> Nest:  # noqa: A001 - mirrors reference API name
    """Apply ``f`` to every leaf of ``n``, preserving structure."""
    if isinstance(n, dict):
        return {k: map(f, v) for k, v in n.items()}
    if isinstance(n, tuple):
        return tuple(map(f, v) for v in n)
    if isinstance(n, list):
        return [map(f, v) for v in n]
    return f(n)


def map_many(f: Callable, *nests: Nest) -> Nest:
    """Apply ``f`` over corresponding leaves of several same-structure nests."""
    n0 = nests[0]
    if isinstance(n0, dict):
        return {k: map_many(f, *(n[k] for n in nests)) for k in n0}
    if isinstance(n0, tuple):
        return tuple(map_many(f, *vs) for vs in _zip(*nests))
    if isinstance(n0, list):
        return [map_many(f, *vs) for vs in _zip(*nests)]
    return f(*nests)


def flatten(n: Nest) -> Iterator[Any]:
    """Yield leaves of ``n`` in deterministic (insertion/index) order."""
    if isinstance(n, dict):
        for v in n.values():
            yield from flatten(v)
    elif isinstance(n, (list, tuple)):
        for v in n:
            yield from flatten(v)
    else:
        yield n


def zip(*nests: Nest):  # noqa: A001 - mirrors reference API name
    """Zip leaves of same-structure nests into tuples (structure preserved)."""
    return map_many(lambda *xs: tuple(xs), *nests)


def pack_as(template: Nest, flat: Sequence[Any]) -> Nest:
    """Inverse of :func:`flatten` given a structure template."""
    it = iter(flat)

    def _take(_):
        return next(it)

    out = map(_take, template)
    rest = list(it)
    if rest:
        raise ValueError(f"pack_as: {len(rest)} leaves left over")
    return out


def _object_array(xs) -> np.ndarray:
    # Non-array leaves (strings, objects) batch as a 1-D object array —
    # still a *leaf* (lists/tuples would read as nest containers).
    out = np.empty(len(xs), dtype=object)
    for i, x in enumerate(xs):
        out[i] = x
    return out


def _stack_leaves(xs, dim):
    if all(isinstance(x, torch.Tensor) for x in xs):
        try:
            return torch.stack(xs, dim=dim)
        except RuntimeError:  # mismatched shapes / devices
            return _object_array(xs)
    if any(isinstance(x, torch.Tensor) for x in xs):
        return _object_array(xs)
    try:
        return np.stack(xs, axis=dim)
    except (TypeError, ValueError):
        return _object_array(xs)


def stack(nests: Sequence[Nest], dim: int = 0) -> Nest:
    """Stack corresponding leaves of ``nests`` along a new axis ``dim``:
    ``torch.stack`` for tensor leaves, ``np.stack`` for numpy/scalar leaves.

    Non-array leaves are collected into a 1-D object array instead (the RPC
    queue batching path sends opaque "info" objects alongside tensors).
    """
    return map_many(lambda *xs: _stack_leaves(xs, dim), *nests)


def _cat_leaves(xs, dim):
    if all(isinstance(x, torch.Tensor) for x in xs):
        return torch.cat(xs, dim=dim)
    return np.concatenate(xs, axis=dim)


def cat(nests: Sequence[Nest], dim: int = 0) -> Nest:
    """Concatenate corresponding leaves of ``nests`` along axis ``dim``."""
    return map_many(lambda *xs: _cat_leaves(xs, dim), *nests)


def unstack(n: Nest, dim: int = 0) -> list:
    """Split every leaf along ``dim`` and return a list of nests."""
    leaves = list(flatten(n))
    if not leaves:
        return []
    first = leaves[0]
    size = np.shape(first)[0 if _is_object_array(first) else dim]
    parts = [
        map(lambda x: _index_axis(x, dim, i), n)  # noqa: B023
        for i in range(size)
    ]
    return parts


def _is_object_array(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype == object


def _index_axis(x, dim, i):
    if _is_object_array(x):  # non-array leaves batched by _stack_leaves
        return x[i]
    idx = [slice(None)] * np.ndim(x)
    idx[dim] = i
    return x[tuple(idx)]


# ------------------------------------------------------------ sorted pytrees
#
# The Accumulator's flatten order is wire protocol: the JAX package flattens
# gradient and parameter trees with ``jax.tree_util.tree_flatten``, which
# visits dict keys in sorted order and treats ``None`` as a node with no
# leaves, so a flat bucket layout or a q8 scale list means the same leaf on
# every peer only when the port flattens the same way.  :func:`flatten`
# above keeps insertion order (the Group's convention in both packages) and
# must not be used there.


class TreeDef:
    """The structure of a tree flattened by :func:`tree_flatten`: hashable
    and comparable (layout caches key on it), and able to rebuild the tree
    from a leaf list (:meth:`unflatten`)."""

    __slots__ = ("_spec", "num_leaves")

    def __init__(self, spec, num_leaves: int):
        self._spec = spec
        self.num_leaves = num_leaves

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self._spec == other._spec

    def __hash__(self):
        return hash(self._spec)

    def __repr__(self):
        return f"TreeDef({self._spec!r})"

    def unflatten(self, leaves: Sequence[Any]) -> Nest:
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(
                f"tree_unflatten: {len(leaves)} leaves for a tree of {self.num_leaves}")
        it = iter(leaves)

        def build(spec):
            if spec is _LEAF:
                return next(it)
            kind, aux, children = spec
            if kind is type(None):
                return None
            vals = [build(c) for c in children]
            if issubclass(kind, dict):
                return kind(_zip(aux, vals))
            if aux == "namedtuple":
                return kind(*vals)
            return kind(vals)

        return build(self._spec)


_LEAF = "*"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Nest):
    """``(leaves, treedef)`` in ``jax.tree_util.tree_flatten``'s order:
    plain dict keys sorted, an ``OrderedDict`` in its own order, tuples,
    lists and namedtuples by position, ``None`` a node without leaves."""
    leaves = []

    def walk(x):
        if x is None:
            return (type(None), None, ())
        if isinstance(x, dict):
            keys = tuple(x) if type(x) is not dict and hasattr(x, "move_to_end") \
                else tuple(sorted(x))
            return (type(x), keys, tuple(walk(x[k]) for k in keys))
        if _is_namedtuple(x):
            return (type(x), "namedtuple", tuple(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return (type(x), None, tuple(walk(v) for v in x))
        leaves.append(x)
        return _LEAF

    spec = walk(tree)
    return leaves, TreeDef(spec, len(leaves))


def tree_unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Nest:
    """Inverse of :func:`tree_flatten`."""
    return treedef.unflatten(leaves)


def tree_leaves(tree: Nest) -> list:
    """The leaves of ``tree`` in :func:`tree_flatten` order."""
    return tree_flatten(tree)[0]


def tree_map(f: Callable, tree: Nest, *rest: Nest) -> Nest:
    """``f`` over corresponding leaves (``rest`` shares ``tree``'s
    structure), rebuilt in ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rd = tree_flatten(r)
        if rd != treedef:
            raise ValueError(f"tree_map: structures differ: {treedef} vs {rd}")
        others.append(rl)
    return treedef.unflatten(f(*xs) for xs in _zip(leaves, *others))
