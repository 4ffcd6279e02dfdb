"""Trees of tensors: nested dicts and lists, walked in one fixed order
(dict insertion order, then list order) by the checkpoint, the
optimizer and the gradient compressor alike."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs; a path joins the dict keys and list indices
    on the way to its leaf with '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    """The leaves of `tree`, in `flatten` order."""
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn, tree):
    """`tree` with every leaf replaced by fn(leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(like, flat):
    """A tree shaped like `like` holding the leaves `flat`, in `flatten`
    order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)
