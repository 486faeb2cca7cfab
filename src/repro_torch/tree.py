"""Nested parameter trees: dicts, lists and tuples (named tuples such as
``AdamWState`` included) with tensors at the leaves, the port's stand-in
for JAX pytrees. Dict keys are visited in sorted order, as JAX flattens a
dict, so a path names the same leaf on both sides."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in ``tree_paths`` order;
    returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs: dict keys in sorted order, list and tuple
    items by index, named-tuple items by field name, joined with "/"
    (the reference checkpointer's leaf keys)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        items = [(join(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(join(f), v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(join(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for p, v in items:
        out.extend(tree_paths(v, p))
    return out


def tree_leaves(tree) -> list:
    """The leaves in ``tree_paths`` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in
    ``tree_paths`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
