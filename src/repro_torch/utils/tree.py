"""Pytree helpers of the port, over parameter trees of tensors: dicts
(flattened in sorted-key order, as jax flattens a dict), tuples, lists
and NamedTuples, with tensors (or None) as leaves.  The counterpart of
the JAX package's ``repro/utils/tree.py``."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in jax's flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError("tree_map: trees with different keys")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("tree_map: trees of different lengths")
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)
