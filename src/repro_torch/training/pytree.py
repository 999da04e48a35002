"""Trees of tensors as the reference's ``jax.tree`` sees them.

The reference keeps parameters, optimizer moments, training state and
partition specs as pytrees (dicts, tuples, NamedTuples) and flattens
them with ``jax.tree.flatten``: dict entries in sorted key order, tuple
and NamedTuple fields in order, ``None`` an empty subtree. The port
keeps the same structures, and flattens them in the same order, so that
a checkpoint's ``leaf_#####.npy`` files line up leaf for leaf in both
packages. As in ``jax.tree``, ``is_leaf`` stops the walk at a node (a
partition spec is a plain tuple), a path is the tuple of dict keys,
NamedTuple field names and sequence indices down to a leaf, and a tree
mapped beside the first only needs the first's structure as a prefix
(its subtree at a leaf is passed whole: a tree of shardings, each a
NamedTuple).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

PyTree = Any
Path = Tuple[Any, ...]
_LEAF = "leaf"


def flatten_with_path(tree: PyTree,
                      is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> Tuple[List[Tuple[Path, Any]], Any]:
    """([(path, leaf)], structure): ``jax.tree_util.tree_flatten_with_path``'s
    order."""
    out: List[Tuple[Path, Any]] = []

    def walk(t, path):
        if is_leaf is not None and is_leaf(t):
            out.append((path, t))
            return _LEAF
        if t is None:
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [walk(t[k], path + (k,)) for k in keys])
        if isinstance(t, (list, tuple)):
            names = getattr(t, "_fields", range(len(t)))  # NamedTuple
            return (type(t), None,
                    [walk(x, path + (k,)) for k, x in zip(names, t)])
        out.append((path, t))
        return _LEAF

    return out, walk(tree, ())


def flatten(tree: PyTree, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Any]:
    """(leaves, structure): ``jax.tree.flatten``'s order."""
    pairs, structure = flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], structure


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


def flatten_up_to(structure: Any, tree: PyTree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``structure``
    (from :func:`flatten`): ``jax``'s ``treedef.flatten_up_to``.  Raises
    where ``tree`` does not have ``structure`` as a prefix."""
    out: List[Any] = []

    def walk(s, t):
        if s == _LEAF:
            out.append(t)
            return
        if s is None:
            if t is not None:
                raise ValueError("trees of different structure")
            return
        kind, keys, kids = s
        if kind is dict:
            if not isinstance(t, dict) or sorted(t) != keys:
                raise ValueError("trees of different structure")
            for k, kid in zip(keys, kids):
                walk(kid, t[k])
            return
        if not isinstance(t, (list, tuple)) or len(t) != len(kids):
            raise ValueError("trees of different structure")
        for kid, x in zip(kids, t):
            walk(kid, x)

    walk(structure, tree)
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of each
    tree in ``rest``."""
    flat, structure = flatten(tree, is_leaf)
    others = [flatten_up_to(structure, r) for r in rest]
    return unflatten(structure, [fn(*xs) for xs in zip(flat, *others)])


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> PyTree:
    """``fn(path, leaf, *others)`` over the leaves of ``tree``."""
    pairs, structure = flatten_with_path(tree, is_leaf)
    others = [flatten_up_to(structure, r) for r in rest]
    return unflatten(structure, [fn(*p, *xs) for p, *xs in
                                 zip(pairs, *others)])
