"""Trees of parameters and optimizer state in JAX's order.

The JAX package flattens nested dicts with sorted keys (lists and tuples
in order), and its checkpoints name each leaf by its path of keys joined
with ``/`` (``opt/m/embed``, ``opt/step``;
``repro.train.checkpoint._flatten_with_paths``).  ``torch.utils._pytree``
keeps a dict's insertion order instead, which would give other leaf
files and another order of ``global_norm``'s sum, so the training modules
flatten with these helpers.  A leaf is anything that is not a dict, list
or tuple; ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_paths(tree) -> tuple[list[str], list]:
    """The leaves of ``tree`` in JAX's order, and their ``/``-joined
    paths."""
    paths, leaves = [], []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for key, child in kids:
            walk(child, prefix + [str(key)])

    walk(tree, [])
    return paths, leaves


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (``jax.tree.leaves``)."""
    return flatten_with_paths(tree)[1]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (in JAX's
    order), as ``jax.tree.unflatten`` does with ``like``'s treedef."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and the
    matching leaves of each tree in ``rest``."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
