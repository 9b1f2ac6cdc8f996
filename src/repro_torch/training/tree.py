"""Nested parameter and optimizer trees in ``jax.tree.flatten``'s order.

The reference's optimizer and checkpoints walk a pytree's leaves in the
order ``jax.tree.flatten`` gives them: the keys of every dict sorted, a
NamedTuple's fields in order. The port keeps the same order, so the global
gradient norm sums in the reference's order and a checkpoint's ``leaf_{i}``
is the same leaf in either package. The port's trees are nested dicts of
tensors and ``AdamWState``: every node that is neither a dict nor a
NamedTuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef): the leaves in ``jax.tree.flatten``'s order and a
    structure that ``unflatten`` fills again."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


# module-level recursion: a nested function that calls itself is a reference
# cycle, and one holding the leaves would keep a model's parameters alive
# until the cyclic collector runs
def _walk(node: Any, leaves: List[Any]) -> Any:
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ("namedtuple", type(node), [_walk(v, leaves) for v in node])
    leaves.append(node)
    return ("leaf",)


def _build(d: Any, it) -> Any:
    if d[0] == "leaf":
        return next(it)
    children = [_build(c, it) for c in d[2]]
    return dict(zip(d[1], children)) if d[0] == "dict" else d[1](*children)


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def treedef_str(treedef: Any) -> str:
    """The structure as ``str(jax treedef)`` prints it, e.g.
    ``PyTreeDef({'a': *, 'b': {'c': *}})``; informational only."""

    def show(d):
        if d[0] == "leaf":
            return "*"
        parts = [show(c) for c in d[2]]
        if d[0] == "dict":
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(d[1], parts)) + "}"
        return d[1].__name__ + "(" + ", ".join(
            f"{f}={p}" for f, p in zip(d[1]._fields, parts)) + ")"

    return f"PyTreeDef({show(treedef)})"
