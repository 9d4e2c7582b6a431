"""The port's state trees, walked in the reference's leaf order.

A tree is a NamedTuple (a sampler state), a dict, a list or tuple, or None
(no leaves); anything else is a leaf (a tensor, a numpy array).  The order
is ``jax.tree_util``'s: NamedTuple fields in order, dict keys sorted,
sequences in order.  ``leaves_with_path`` gives each leaf's path as
``jax.tree_util.keystr`` writes it (``.field``, ``['key']``, ``[i]``), so
checkpoint leaf keys agree with the reference's."""
from __future__ import annotations


def _children(node):
    """(path entries, children) of an inner node; None for a leaf."""
    if node is None:
        return [], []
    if isinstance(node, dict):
        keys = sorted(node)
        return [f"[{k!r}]" for k in keys], [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [f"[{i}]" for i in range(len(node))], list(node)
    return None


def leaves_with_path(tree, prefix: str = "") -> list:
    """[(keystr path, leaf), ...] in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for entry, child in zip(*kids)
            for pair in leaves_with_path(child, prefix + entry)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn, tree):
    """The tree with ``fn`` applied to every leaf in leaf order (same node
    types; a dict comes back with its keys sorted, as JAX's does)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k])) for k in sorted(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(like, new_leaves):
    """A tree shaped as ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), like)
