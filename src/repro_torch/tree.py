"""Parameter and state trees of the port: nested dicts, lists, tuples and
NamedTuples with tensors (or Python numbers) at the leaves, the shapes
``jax.tree_util`` walks in the JAX package.  Leaves are visited in JAX's
order (dict keys sorted, sequences and NamedTuple fields in order), and
:func:`flatten_with_paths` names each leaf by the path string the JAX
``Checkpointer`` writes (``checkpointer.py:25-31``): dict keys and
sequence indices as they print, a NamedTuple field as ``.field``, joined
by ``/`` (``params/groups/0/0/mixer/wq``, ``opt/.m/embedding/table``).
``None`` is an empty subtree, as in JAX."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of an inner node in JAX's order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _map(fn, is_leaf, node, others):
    if node is None:
        return None
    if is_leaf is not None and is_leaf(node):
        return fn(node, *others)
    if isinstance(node, dict):
        return {k: _map(fn, is_leaf, node[k], [r[k] for r in others])
                for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_map(fn, is_leaf, c, [r[i] for r in others])
                            for i, c in enumerate(node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, is_leaf, c, [r[i] for r in others])
                          for i, c in enumerate(node))
    return fn(node, *others)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure;
    a node for which ``is_leaf`` is true is a leaf, as in JAX.  (The walks
    here are module-level functions, not recursive closures: a closure
    that calls itself is a reference cycle, and would hold the tensors it
    reaches until Python's cyclic collector ran.)"""
    return _map(fn, is_leaf, tree, rest)


def _flatten(node, prefix, is_leaf, out):
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) else \
        _children(node)
    if kids is None:
        out["/".join(prefix)] = node
        return
    for part, child in kids:
        _flatten(child, prefix + [part], is_leaf, out)


def flatten_with_paths(tree, is_leaf: Optional[Callable] = None
                       ) -> Dict[str, Any]:
    """Path string -> leaf, in JAX's leaf order; a node for which
    ``is_leaf`` is true is a leaf."""
    out: Dict[str, Any] = {}
    _flatten(tree, [], is_leaf, out)
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX's order."""
    return list(flatten_with_paths(tree).values())


def _build(node, prefix, by_path):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return by_path["/".join(prefix)]
    if isinstance(node, dict):
        return {k: _build(node[k], prefix + [str(k)], by_path) for k in node}
    parts = [_build(c, prefix + [p], by_path) for p, c in kids]
    return type(node)(*parts) if _is_namedtuple(node) else type(node)(parts)


def unflatten_like(like, by_path: Dict[str, Any]):
    """``like``'s structure with the leaf at each path taken from
    ``by_path``."""
    return _build(like, [], by_path)
