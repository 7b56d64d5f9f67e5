"""Nested dict/list parameter and cache trees (the port's stand-in for
JAX pytrees): leaves are tensors or ints, containers are dicts (keys
visited in sorted order, as JAX does) and lists/tuples."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *[r[i] for r in rest])
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in tree_map's visiting order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` in tree_map's order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
