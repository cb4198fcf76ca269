"""Trees of tensors: nested dicts, lists and tuples, walked in the order
JAX flattens a pytree (dict keys sorted, list and tuple items by index).
The optimizers, the gradient compression and the checkpointer take their
state as such trees, as the JAX package's take pytrees."""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]``, ``path`` the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += flatten(tree[key], prefix + (key,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += flatten(item, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the leaves at the same places
    of ``rest`` (trees of ``tree``'s structure), into ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree: Any, values) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``values``, taken in
    ``flatten``'s order."""
    return _build(tree, iter(values))


def _build(node: Any, it) -> Any:
    # a module function, not a closure over itself: such a closure is a
    # reference cycle, which would keep ``values`` alive until the cyclic
    # collector runs
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)
