"""Nested dicts, lists and tuples of tensors, flattened in ``jax.tree``'s order.

The port's parameters, gradients and optimizer moments are the reference's
pytrees as plain nested dicts and lists (:func:`repro_torch.models.gnn.init`).
These helpers flatten them as ``jax.tree.flatten`` does — dict keys in
sorted order, lists and tuples in order — so that a leaf's index (the
``k`` of the gradient all-reduce's phase ``grad/allreduce[k]``) is the
reference's.  A ``NamedTuple`` is a leaf here; no caller nests one.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def flatten(tree) -> tuple[list, Callable[[list], Any]]:
    """``tree``'s leaves, and a function that builds the same structure
    around a new list of as many leaves."""
    flat = leaves(tree)

    def unflatten(new: list):
        if len(new) != len(flat):
            raise ValueError(f"unflatten: {len(new)} leaves for a tree of {len(flat)}")
        it = iter(new)
        return _rebuild(tree, it)

    return flat, unflatten


def _rebuild(tree, it):
    if isinstance(tree, dict):
        out = {k: None for k in tree}  # keep the caller's key order
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], it)
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf."""
    flat, unflatten = flatten(tree)
    others = [leaves(t) for t in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree_map: trees of {len(flat)} and {len(o)} leaves")
    return unflatten([fn(*xs) for xs in zip(flat, *others)])
