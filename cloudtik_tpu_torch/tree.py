"""Nested dicts, lists and tuples of tensors as trees: the port's
counterpart of the `jax.tree` helpers it needs for parameter, gradient and
optimizer trees (a ResNet's stages are lists of block dicts)."""

from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of trees of the same structure; dicts, lists and
    tuples keep their container type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in insertion order, as `tree_map` visits them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """`leaves` (in `tree_leaves` order) put back into the structure of
    `like`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
