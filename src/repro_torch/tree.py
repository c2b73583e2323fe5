"""Nested containers in the JAX package's pytree leaf order.

The training state is nested dicts, NamedTuples (``AdamWState``), lists
and tuples of tensors and Python scalars. The JAX package walks such a tree
with ``jax.tree_util``: dict keys in sorted order, NamedTuple and sequence
fields in order, ``None`` an empty node with no leaf. The port walks it the
same way, so the global gradient norm adds its per-leaf sums in the
reference's order and a checkpoint's ``arr_%05d.npy`` files are numbered
alike by both packages (checkpoint/store.py)."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = object()


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten_into(t, leaves: List[Any]):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if _is_namedtuple(t):
        return type(t)(*(_flatten_into(v, leaves) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten_into(v, leaves) for v in t)
    leaves.append(t)
    return _LEAF


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``: the leaves in JAX's order and the structure with
    every leaf replaced by a marker (for :func:`unflatten`). The walks are
    module-level functions: a nested recursive function is a reference
    cycle, which would keep the leaves it reached (a step's gradients)
    alive until the garbage collector runs."""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(s, it):
    if s is _LEAF:
        return next(it)
    if s is None:
        return None
    if isinstance(s, dict):
        return {k: _build(v, it) for k, v in s.items()}
    if _is_namedtuple(s):
        return type(s)(*(_build(v, it) for v in s))
    return type(s)(_build(v, it) for v in s)


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` (from :func:`flatten`) over ``leaves``."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have the same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(spec, [fn(*args) for args in zip(flat, *others)])


def spec_str(spec) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(...))`` prints
    it, e.g. ``PyTreeDef({'a': *, 'b': CustomNode(namedtuple[S], [*])})``."""
    def fmt(s):
        if s is _LEAF:
            return "*"
        if s is None:
            return "None"
        if isinstance(s, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(v)}" for k, v in s.items()) + "}"
        if _is_namedtuple(s):
            return (f"CustomNode(namedtuple[{type(s).__name__}], ["
                    + ", ".join(fmt(v) for v in s) + "])")
        if isinstance(s, tuple):
            inner = ", ".join(fmt(v) for v in s)
            return f"({inner},)" if len(s) == 1 else f"({inner})"
        return "[" + ", ".join(fmt(v) for v in s) + "]"
    return f"PyTreeDef({fmt(spec)})"
