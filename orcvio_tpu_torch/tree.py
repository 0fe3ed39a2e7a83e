"""Trees of tensors: dataclasses registered as torch pytree nodes.

The counterpart of the JAX package's flax struct dataclasses. The state of
the filter, the tracker and the initializers is made of them, so that
``torch.func.vmap`` maps over their tensors and a batch of states is one
tree of stacked leaves.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils._pytree as pytree


class Tree:
    """A dataclass whose fields are tensors or further trees, registered as
    a torch pytree node (so ``torch.func.vmap`` maps over its tensors). The
    fields named in ``_static`` are not leaves: they ride in the node's
    context, outside vmap, as the JAX package's static pytree fields do."""

    _static: tuple = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        pytree.register_pytree_node(cls, _flatten, functools.partial(
            _unflatten, cls))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _flatten(tree):
    names = [f.name for f in dataclasses.fields(tree)
             if f.name not in tree._static]
    static = tuple((n, getattr(tree, n)) for n in tree._static)
    return [getattr(tree, n) for n in names], (tuple(names), static)


def _unflatten(cls, children, context):
    names, static = context
    return cls(**dict(zip(names, children)), **dict(static))


def tree_map(fn, *trees):
    """fn over the tensor leaves of trees of one layout."""
    return pytree.tree_map(fn, *trees)


def tree_where(cond, a, b):
    """Field by field torch.where(cond, a, b): JAX's tree-mapped jnp.where."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def tree_stack(trees):
    """One tree of B trees of one layout, each leaf stacked on a new leading
    axis (JAX's tree-mapped jnp.stack); static fields are the first's."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree, b: int):
    """Row b of a stacked tree."""
    return tree_map(lambda x: x[b], tree)
