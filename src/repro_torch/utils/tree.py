"""Tree utilities over nested dicts of tensors (the reference's
``utils/tree.py``, without jax).

A tree is a dict (flattened in sorted key order, as jax flattens dicts),
a list or tuple, ``None`` (no leaves) or a dataclass instance such as
``TrainState`` (its fields in order).  Anything else is a leaf.
``flatten_with_paths`` names leaves as the reference does, letter for
letter: dict keys and sequence indices joined by ``/``, and a dataclass
field as ``[<flat index i>]`` (the reference registers ``TrainState``
as a pytree without keys), so checkpoints interchange between the two.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _children(tree):
    """``(names, children, rebuild)`` of an inner node, or ``None`` for
    a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([str(k) for k in keys], [tree[k] for k in keys],
                lambda vals: dict(zip(keys, vals)))
    if isinstance(tree, (list, tuple)):
        return ([str(i) for i in range(len(tree))], list(tree),
                lambda vals: type(tree)(vals))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = [f.name for f in dataclasses.fields(tree)]
        return ([f"[<flat index {i}>]" for i in range(len(fields))],
                [getattr(tree, f) for f in fields],
                lambda vals: type(tree)(*vals))
    return None


def flatten_with_paths(tree) -> list:
    """``[(path_string, leaf)]`` in the reference's order and naming
    (the checkpointer's file names)."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [("", tree)]
    out = []
    for name, child in zip(node[0], node[1]):
        for sub, leaf in flatten_with_paths(child):
            out.append((f"{name}/{sub}" if sub else name, leaf))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    others = [_children(r)[1] for r in rest]
    return node[2]([tree_map(fn, c, *(o[i] for o in others))
                    for i, c in enumerate(node[1])])


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` (in
    ``flatten_with_paths`` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template")
    return out


def param_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, in float32 (gradient clipping)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def has_nan(tree) -> torch.Tensor:
    """True where any leaf holds a NaN or an infinity."""
    leaves = tree_leaves(tree)
    return torch.stack([~torch.isfinite(x.float()).all()
                        for x in leaves]).any()
