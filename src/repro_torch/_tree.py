"""Minimal pytree helpers over nested dicts, lists and tuples.

Leaves are enumerated in ``jax.tree.flatten`` order: dict keys SORTED,
sequences in order.  The fault seeds stride by a leaf's flatten index
(``seed + 977 * j``), so this order is part of the seed contract shared
with the reference.
"""
from __future__ import annotations

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "tree_leaves",
           "tree_flatten_with_path"]


def tree_flatten(tree):
    leaves = []

    def rec(t):
        if isinstance(t, dict):
            return (dict, [(k, rec(t[k])) for k in sorted(t)])
        if isinstance(t, (list, tuple)):
            return (type(t), [rec(v) for v in t])
        leaves.append(t)
        return None

    return leaves, rec(tree)


def tree_unflatten(spec, leaves):
    it = iter(leaves)

    def rec(s):
        if s is None:
            return next(it)
        kind, children = s
        if kind is dict:
            return {k: rec(c) for k, c in children}
        return kind(rec(c) for c in children)

    return rec(spec)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


def tree_flatten_with_path(tree) -> tuple[list[tuple[tuple, object]], tuple]:
    """``([(path, leaf), ...], spec)`` in ``tree_flatten`` order, where
    ``path`` holds each step down to the leaf as
    ``jax.tree_util.tree_flatten_with_path`` names it: a dict's key, a
    sequence's integer index.  ``"§".join(map(str, path))`` is then the key
    the reference's checkpoints store a leaf under."""
    leaves, spec = tree_flatten(tree)
    paths = []

    def rec(s, path):
        if s is None:
            paths.append(path)
            return
        kind, children = s
        if kind is dict:
            for k, c in children:
                rec(c, path + (k,))
        else:
            for i, c in enumerate(children):
                rec(c, path + (i,))

    rec(spec, ())
    return list(zip(paths, leaves)), spec
