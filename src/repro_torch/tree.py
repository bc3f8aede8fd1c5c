"""Trees of tensors: leaf paths, leaves and maps over the frozen
dataclasses, NamedTuples, dicts and lists the port's states, metrics and
parameters are made of (`torch.utils._pytree` is private)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


def _children(node):
    """(name, child) pairs of an inner node, or None for a leaf. Dict keys
    in sorted order (as `jax.tree_util`), NamedTuple and dataclass fields
    by name, list and tuple items by index; None has no leaves."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if node is None:
        return []
    return None


def leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} in tree order: dict keys, NamedTuple fields and
    dataclass attributes joined by "/"."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for name, child in kids:
        out.update(leaf_paths(child, f"{prefix}/{name}" if prefix else name))
    return out


def rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """`tree`'s structure with every leaf replaced by leaves[path]."""
    kids = _children(tree)
    if kids is None:
        return leaves[prefix]
    new = {name: rebuild(child, leaves, f"{prefix}/{name}" if prefix else name)
           for name, child in kids}
    if isinstance(tree, dict):
        return type(tree)((k, new[str(k)]) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**new)
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[str(i)] for i in range(len(tree)))
    if tree is None:
        return None
    return dataclasses.replace(tree, **new)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in path order."""
    return list(leaf_paths(tree).values())


def tree_map(fn, tree, *rest):
    """`fn` leaf by leaf over trees of `tree`'s structure."""
    others = [leaf_paths(t) for t in rest]
    return rebuild(tree, {k: fn(v, *(o[k] for o in others))
                           for k, v in leaf_paths(tree).items()})
