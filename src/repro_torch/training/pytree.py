"""Trees of tensors as the reference's ``jax.tree`` sees them.

The reference keeps parameters, optimizer moments and training state as
pytrees (dicts, tuples, NamedTuples) and flattens them with
``jax.tree.flatten``: dict entries in sorted key order, tuple and
NamedTuple fields in order, ``None`` an empty subtree.  The port keeps
the same structures, and flattens them in the same order, so that a
checkpoint's ``leaf_#####.npy`` files line up leaf for leaf in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any
_LEAF = "leaf"


def flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """(leaves, structure): ``jax.tree.flatten``'s order."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t), None, [walk(x) for x in t])
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def unflatten(structure: Any, leaves) -> PyTree:
    """The tree of ``structure`` (from :func:`flatten`) over ``leaves``."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == _LEAF:
            return next(it)
        kind, keys, kids = s
        vals = [build(k) for k in kids]
        if kind is dict:
            return dict(zip(keys, vals))
        if kind in (list, tuple):
            return kind(vals)
        return kind(*vals)  # a NamedTuple

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree: PyTree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    flat, structure = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(structure, [fn(*xs) for xs in zip(flat, *others)])
