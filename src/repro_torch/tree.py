"""Nested dicts, lists, tuples and ``NamedTuple``s of tensors, flattened in
``jax.tree``'s order.

The port's parameters, gradients and optimizer moments are the reference's
pytrees as plain nested dicts and lists (:func:`repro_torch.models.gnn.init`),
and a train state is the reference's ``NamedTuple``s around them
(:class:`repro_torch.train.step.TrainState`).  These helpers flatten them
as ``jax.tree.flatten`` does -- dict keys in sorted order, lists, tuples
and a ``NamedTuple``'s fields in order, ``None`` a node with no leaves --
so that a leaf's index (the ``k`` of the gradient all-reduce's phase
``grad/allreduce[k]``, a checkpoint's ``arr_k``) is the reference's.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
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
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: None for k in tree}  # keep the caller's key order
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], it)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def structure(tree) -> str:
    """A readable string of ``tree``'s structure, ``*`` for each leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(structure(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    return "*"


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf."""
    flat, unflatten = flatten(tree)
    others = [leaves(t) for t in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree_map: trees of {len(flat)} and {len(o)} leaves")
    return unflatten([fn(*xs) for xs in zip(flat, *others)])
