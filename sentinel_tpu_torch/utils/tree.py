"""Trees of tensors: NamedTuples nested in NamedTuples, ``None`` for an
absent part (the port's states and rule packs).

The leaf order is the JAX package's ``jax.tree.leaves`` order: field order,
depth first, ``None`` subtrees dropped. The pod checkpoint's files are
written in it (``core/checkpoint.py``), so either package reads the
other's.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import torch


def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, *trees):
    """``fn`` over the matching tensor leaves of NamedTuple trees; a
    ``None`` subtree stays ``None``."""
    t0 = trees[0]
    if t0 is None:
        return None
    if _is_tree(t0):
        return type(t0)(*(tree_map(fn, *(getattr(t, f) for t in trees))
                          for f in t0._fields))
    return fn(*trees)


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted field path, tensor) of every leaf, in leaf order."""
    if tree is None:
        return []
    if _is_tree(tree):
        return [x for f in tree._fields
                for x in named_leaves(getattr(tree, f), prefix + f + ".")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]


def tree_unflatten(like, leaves: Iterable[torch.Tensor]):
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
