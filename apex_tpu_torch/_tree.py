"""Pytree helpers of the port: nested dicts, lists, tuples and NamedTuples
of tensors, flattened in the JAX package's leaf order.

JAX flattens a dict by its sorted keys, a list or tuple (NamedTuples
included) in order, and ``None`` as a node with no leaves. The same
order here is what lets a flat buffer packed by the port hold every
leaf at the offset the JAX package gives it, so an optimizer state
crosses between the two as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

#: a leaf's place in a :class:`TreeSpec`
_LEAF = object()


class TreeSpec:
    """The structure of a tree with its leaves taken out; hashable and
    comparable, so a layout that holds it can be checked against a
    tree."""

    def __init__(self, node):
        self._node = node

    def __eq__(self, other):
        return isinstance(other, TreeSpec) and self._node == other._node

    def __hash__(self):
        return hash(self._node)

    def __repr__(self):
        return f"TreeSpec({self._node!r})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any) -> Tuple[List[Any], TreeSpec]:
    """``(leaves, spec)``: the leaves in JAX order and the structure."""
    leaves: List[Any] = []

    def rec(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(rec(t[k]) for k in keys))
        if _is_namedtuple(t):
            return ("namedtuple", type(t), tuple(rec(x) for x in t))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(rec(x) for x in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return _LEAF

    return leaves, TreeSpec(rec(tree))


def unflatten(spec: TreeSpec, leaves) -> Any:
    """The tree of ``spec`` with ``leaves`` put back in order."""
    it = iter(leaves)

    def rec(node):
        if node is _LEAF:
            return next(it)
        kind = node[0]
        if kind == "dict":
            return {k: rec(n) for k, n in zip(node[1], node[2])}
        if kind == "namedtuple":
            return node[1](*(rec(n) for n in node[2]))
        if kind == "none":
            return None
        children = [rec(n) for n in node[1]]
        return children if kind == "list" else tuple(children)

    out = rec(spec._node)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree structure holds")
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-structured
    ``rest``, leaf by leaf, into a tree of ``tree``'s structure."""
    lv, spec = flatten(tree)
    others = []
    for r in rest:
        rl, rspec = flatten(r)
        if rspec != spec:
            raise ValueError("tree structures differ")
        others.append(rl)
    return unflatten(spec, [fn(*xs) for xs in zip(lv, *others)])
