"""Checkpoint helpers of the port.

Only :func:`canonical_tree` is here: the Accumulator pickles its model-sync
blob through it, so a port leader and a JAX leader produce the same bytes
for the same values.  The single-host ``Checkpointer`` and the
``DistributedCheckpointer`` of the JAX package come with ROADMAP slice 7;
importing either raises until then.
"""

from __future__ import annotations

from typing import Any


def canonical_tree(tree: Any) -> Any:
    """Rebuild ``tree`` with plain-dict keys in sorted order, recursively.

    Replicated state must pickle to identical bytes on every host, but dict
    *insertion* order is a host-local artifact: a tree rebuilt from a sorted
    flatten/unflatten round-trip iterates keys sorted, while one that arrived
    through a pickle-based model sync keeps its original order.  Same values,
    different bytes, different digest.  Sorting matches the sorted-key
    flatten convention (``utils.nest.tree_flatten``), so restored trees are
    semantically unchanged.
    """
    if type(tree) is dict:
        return {k: canonical_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple):
        vals = [canonical_tree(v) for v in tree]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*vals)
        return tuple(vals)
    if type(tree) is list:
        return [canonical_tree(v) for v in tree]
    return tree


def __getattr__(name):
    if name in ("Checkpointer", "DistributedCheckpointer"):
        raise ImportError(f"checkpoint.{name}: not yet ported (slice 7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
