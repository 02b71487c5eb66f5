"""Nested containers of tensors, flattened in the JAX package's pytree
order: a dict's keys sorted, a NamedTuple's fields and a list's or
tuple's items in order, None an empty subtree; a
:class:`~repro_torch.models.params.ParamTree` module flattens as its
nested dict view.  Everything else is a leaf.  With that order a
checkpoint's ``leaf_XXXXX`` numbering, the AdamW state's and a global
norm's sum order are the reference's."""

from __future__ import annotations

from typing import Any, Callable


def _children(node):
    """(the node's children in order, a function rebuilding the node
    from new children), or None for a leaf."""
    from repro_torch.models.params import ParamTree

    if isinstance(node, ParamTree):
        node = node.tree()
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), lambda xs: type(node)(*xs)
    if isinstance(node, (list, tuple)):
        return list(node), lambda xs: type(node)(xs)
    if node is None:
        return [], lambda xs: None
    return None


def leaves(tree) -> list:
    """The leaves of ``tree`` in pytree order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids[0] for leaf in leaves(k)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure (a ``ParamTree`` becomes its nested dict)
    holding ``new_leaves`` in pytree order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return kids[1]([build(k) for k in kids[0]])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and those of ``rest``, trees of
    the same structure), in ``tree``'s structure."""
    outs = [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))]
    return unflatten(tree, outs)

