"""Trees of tensors: nested dicts and lists, as the port's model parameters
(`models/transformer.py`), the optimiser's state and a checkpoint hold
them (the JAX package's pytrees).

`leaves` / `unflatten` take the leaves in one fixed order: a dict's keys
sorted (the order `jax.tree` gives a dict), a list's items in turn.
`stacked_order` takes them in the JAX pytree's order, where a list of
blocks is one stacked tree of (L, ...) leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List

Tree = Any


def leaves(tree: Tree) -> List[Any]:
    """The leaves, dict keys sorted and list items in turn."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def unflatten(like: Tree, values) -> Tree:
    """A tree of `like`'s structure holding `values` in `leaves` order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}       # like's key order
        if isinstance(t, list):
            return [build(item) for item in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the tree has leaves")
    return out


def map_tree(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` and of the trees of its structure in
    `rest`, as a tree of that structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])


def describe(tree: Tree) -> str:
    """The tree's structure, each leaf a '*' (a checkpoint's treedef)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(describe(item) for item in tree) + "]"
    return "*"


def stacked_order(tree: Tree) -> Iterator[Any]:
    """The leaves in the JAX pytree's order: a list (a layer stack; a list
    of lists, the hybrid's groups, in group-major order) is read as one
    stacked tree, each leaf path in sorted order over every item that
    has it, in turn, as the (L, ...) leaf the JAX package stacks them
    into ravels. Where the two layouts part (the moe family's one list
    of blocks is the JAX package's dense_blocks and moe_blocks), the
    order is this one's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from stacked_order(tree[k])
    elif isinstance(tree, list):
        items = _items(tree)
        if items and isinstance(items[0], dict):
            for k in sorted({k for item in items for k in item}):
                yield from stacked_order([item[k] for item in items
                                          if k in item])
        else:
            yield from items
    else:
        yield tree


def _items(stack: list) -> list:
    """A list of lists flattened to one list, in order."""
    return [x for item in stack
            for x in (_items(item) if isinstance(item, list) else [item])]
