"""Parameter trees: nested dicts and lists of tensors (the port's stand-in
for ``jax.tree``).  Leaves are visited in a fixed order: dict keys sorted,
list items in order, so two trees of one structure line up leaf for
leaf."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["leaves", "tree_map", "paths"]


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in order (None leaves skipped)."""
    return [leaf for _, leaf in paths(tree).items()]


def tree_map(fn: Callable, tree, *rest):
    """A tree of ``tree``'s structure holding ``fn(leaf, *same leaves of
    rest)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/0/b": leaf, ...}``: every non-None leaf under its path of
    keys and list indices, in order."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if tree is not None:
            out[prefix] = tree
        return out
    for key, sub in items:
        out.update(paths(sub, f"{prefix}/{key}" if prefix else key))
    return out
