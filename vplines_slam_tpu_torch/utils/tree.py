"""Minimal pytree helpers over tuples and NamedTuples of tensors."""

from __future__ import annotations


def _is_node(x):
    return isinstance(x, tuple)


def tree_map(f, tree, *rest):
    """Apply f leafwise over structurally identical (Named)tuple trees."""
    if _is_node(tree):
        kids = [tree_map(f, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return f(tree, *rest)


def tree_leaves(tree):
    if _is_node(tree):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]
