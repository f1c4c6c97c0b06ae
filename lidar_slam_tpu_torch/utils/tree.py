"""Walking the port's states: ``NamedTuple``s (and dicts, lists, tuples) of
tensors, host numbers and ``torch.Generator``s — what a JAX pytree is to
the JAX package. Used by ``utils/checkpoint`` and ``utils/debug``.

Paths are written as JAX's ``keystr`` writes them: ``.field`` for a
``NamedTuple`` field, ``['key']`` for a dict key, ``[i]`` for an item.
"""

from __future__ import annotations

import numpy as np
import torch


def is_generator(x) -> bool:
    """A ``torch.Generator`` or anything that saves and restores like one
    (``get_state``/``set_state`` and a ``device``)."""
    return (not isinstance(x, torch.Tensor)
            and all(hasattr(x, a) for a in ("get_state", "set_state",
                                            "device")))


def _children(tree, path: str):
    """[(path, child)] of a container, or None for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f"{path}.{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(f"{path}[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"{path}[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_path(tree, path: str = ""):
    """Yield (path, leaf) in a fixed order."""
    kids = _children(tree, path)
    if kids is None:
        yield path, tree
        return
    for p, child in kids:
        yield from leaves_with_path(child, p)


def map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *leaves of rest at the same path)`` over every leaf,
    rebuilt into ``tree``'s structure (``rest`` must share it)."""
    kids = _children(tree, path)
    if kids is None:
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=p) for k, (p, _) in zip(keys, kids)}
    vals = [map_with_path(fn, child, *(r[i] for r in rest), path=p)
            for i, (p, child) in enumerate(kids)]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def leaf_kind(x) -> str:
    """The kind of a leaf, as the structure string records it."""
    if isinstance(x, torch.Tensor):
        return f"tensor[{str(x.dtype).removeprefix('torch.')}]"
    if is_generator(x):
        return "generator"
    if x is None:
        return "None"
    if isinstance(x, (bool, np.bool_)):
        return "bool"
    if isinstance(x, (int, np.integer)):
        return "int"
    if isinstance(x, (float, np.floating)):
        return "float"
    raise TypeError(f"unsupported leaf {type(x).__name__}")


def structure(tree) -> str:
    """Container types, field names and leaf kinds, as one string."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(f"{f}={structure(getattr(tree, f))}"
                          for f in tree._fields)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return leaf_kind(tree)
