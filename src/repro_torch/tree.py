"""Parameter trees in the reference's leaf order.

The reference flattens its trees with JAX, which walks a dict in sorted
key order, a list or tuple by index, and treats None as an empty
subtree. The port's dicts keep insertion order (``init_params`` makes
``embed``, then ``blocks``, then ``final_norm``), so everything that
depends on the order of leaves — the optimizer's global gradient norm,
summed leaf by leaf, and the checkpoint's object names and manifest —
walks the tree through this module instead of ``dict.values()``.

Containers are dicts, lists and tuples (of exactly those types: a tuple
subclass such as ``parallel.sharding.PartitionSpec`` is a leaf). A
leaf's name joins its path with ``/``: a dict key as itself, a list
item as its index (``opt/m/blocks/w1``, ``opt/step``, ``params/embed``),
as the reference's checkpoint store names them.
"""

from __future__ import annotations

from typing import Callable


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(name, leaf), ...]`` in the reference's (JAX's) leaf order."""
    out: list[tuple[str, object]] = []
    _walk(tree, prefix, out)
    return out


def _walk(tree, name: str, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{name}/{k}" if name else str(k), out)
    elif type(tree) in (list, tuple):
        for i, v in enumerate(tree):
            _walk(v, f"{name}/{i}" if name else str(i), out)
    else:
        out.append((name, tree))


def leaves(tree) -> list:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in flatten_with_names(tree)]


def unflatten(template, new_leaves) -> object:
    """``template``'s structure with its leaves, taken in the reference's
    order, replaced by ``new_leaves``."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template holds")
    return out


_END = object()


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        # leaves are consumed in sorted key order; the dict keeps its own
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if type(tree) in (list, tuple):
        return type(tree)(_rebuild(v, it) for v in tree)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the template holds")
    return leaf


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
