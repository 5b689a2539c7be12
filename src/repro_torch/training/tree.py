"""Nested dicts, lists and tuples of tensors: the port's parameter trees.

The JAX package keeps parameters and optimizer state as pytrees and walks
them with ``jax.tree_util``. The port keeps a model's parameters in an
``nn.Module`` and hands the optimizer its :func:`module_tree`: a nested
dict of the module's parameters by name, with the numbered children of a
``ModuleList`` as a list (``layers.3.attn.wq`` becomes
``tree["layers"][3]["attn"]["wq"]``). The walkers here visit leaves in
``jax.tree_util.tree_flatten``'s order: dict keys sorted, sequences in
order, ``None`` an empty node.
"""

from __future__ import annotations

from torch import nn


class _Leaf:
    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order."""
    out: list = []
    _walk(tree, out)
    return out


# module-level recursions: a nested function that calls itself is a
# reference cycle (the function and its own closure cell), which would
# keep the list of leaves, and every tensor in it, alive until the
# cyclic garbage collector runs (a training step's gradients and updates
# stayed alive into the next step)
def _walk(node, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _walk(v, out)
    elif node is not None:
        out.append(node)


def structure(tree):
    """``tree`` with every leaf replaced by :data:`LEAF` (the port's
    treedef)."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(structure(v) for v in tree)
    return None if tree is None else LEAF


def unflatten(struct, flat: list):
    """Fill ``struct`` (from :func:`structure`) with ``flat`` in leaf
    order; the inverse of :func:`leaves`."""
    it = iter(flat)
    out = _fill(struct, it)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def _fill(node, it):
    if isinstance(node, dict):
        got = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: got[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, it) for v in node)
    return None if node is None else next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); ``None`` nodes stay ``None``."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(structure(tree), [fn(*xs) for xs in zip(*flat)])


def paths(tree, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's path of keys and indices, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k],
                                                       prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v,
                                                             prefix + (i,))]
    return [] if tree is None else [prefix]


def module_tree(module: nn.Module) -> dict | list:
    """``module``'s parameters as a nested tree by name, a child module a
    subtree (one without parameters an empty dict, as the reference's
    ``{}`` of a non-parametric norm); numbered children (a ``ModuleList``)
    become lists. The leaves are the live parameters."""
    node: dict = {k: p for k, p in module._parameters.items()
                  if p is not None}
    for name, child in module.named_children():
        node[name] = module_tree(child)
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node
