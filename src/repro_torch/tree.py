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


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure;
    a node for which ``is_leaf`` is true is a leaf, as in JAX."""
    def walk(node, *others):
        if node is None:
            return None
        if is_leaf is not None and is_leaf(node):
            return fn(node, *others)
        if isinstance(node, dict):
            return {k: walk(node[k], *(r[k] for r in others)) for k in node}
        if _is_namedtuple(node):
            return type(node)(*(walk(c, *(r[i] for r in others))
                                for i, c in enumerate(node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c, *(r[i] for r in others))
                              for i, c in enumerate(node))
        return fn(node, *others)
    return walk(tree, *rest)


def flatten_with_paths(tree, is_leaf: Optional[Callable] = None
                       ) -> Dict[str, Any]:
    """Path string -> leaf, in JAX's leaf order; a node for which
    ``is_leaf`` is true is a leaf."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if node is None:
            return
        kids = None if is_leaf is not None and is_leaf(node) else \
            _children(node)
        if kids is None:
            out["/".join(prefix)] = node
            return
        for part, child in kids:
            walk(child, prefix + [part])

    walk(tree, [])
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX's order."""
    return list(flatten_with_paths(tree).values())


def unflatten_like(like, by_path: Dict[str, Any]):
    """``like``'s structure with the leaf at each path taken from
    ``by_path``."""
    def build(node, prefix):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return by_path["/".join(prefix)]
        if isinstance(node, dict):
            return {k: build(node[k], prefix + [str(k)]) for k in node}
        parts = [build(c, prefix + [p]) for p, c in kids]
        return type(node)(*parts) if _is_namedtuple(node) else \
            type(node)(parts)
    return build(like, [])
