"""Nested dicts of tensors as trees: the port's counterpart of the
`jax.tree` helpers it needs for parameter, gradient and optimizer trees."""

from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in insertion order, as `tree_map` visits them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
