"""Trees of tensors: the port's params, grads, optimizer states and
checkpoints are dicts, lists and tuples (``NamedTuple`` included) of
tensors.  One walk order serves every module: dict keys sorted, lists and
tuples in order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaves_with_paths(tree, is_leaf: Optional[Callable] = None,
                      prefix: str = "") -> List[Tuple[str, Any]]:
    """``[("a/0/b", leaf), ...]``: every leaf with its path; ``is_leaf``
    may stop the walk at a container (a factored ``nu``'s (row, col)
    pair)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [x for k, v in items for x in leaves_with_paths(
        v, is_leaf, f"{prefix}/{k}" if prefix else str(k))]


def leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    """The leaves of ``tree``, in walk order."""
    return [v for _, v in leaves_with_paths(tree, is_leaf)]


def unflatten(like, values: list):
    """``values`` (in ``leaves(like)`` order) in the structure of ``like``."""
    return _build(like, iter(values))


def _build(t, it):
    # a module-level function: a recursive closure is a reference cycle,
    # which would keep ``values`` (a step's grads) alive until the cyclic
    # garbage collector runs
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):       # NamedTuple
        return type(t)(*(_build(v, it) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def records_grad(*ts: torch.Tensor) -> bool:
    """True when autograd would record an op on ``ts``: grad is enabled and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)
