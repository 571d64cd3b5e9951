"""Flat parameter views (counterpart of util/flat_params.py).

Every network exposes its params (and updater state) as one flat vector:
checkpointing, parameter averaging and gradient checks read it. The order
is the JAX package's, which is `jax.tree_util.tree_leaves`' order: list
and tuple entries in sequence, dict entries by SORTED key at every level
(so a layer's {"w_q", "w_k", "w_v", "w_o", "b"} flattens as b, w_k, w_o,
w_q, w_v), and None as no leaf. `tree_leaves` here walks a nest of
lists, tuples and dicts of tensors in that order.
"""
from __future__ import annotations

from typing import Any, List

import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nest of lists, tuples and dicts, in JAX's leaf
    order (dict keys sorted; None holds no leaf)."""
    out: List[torch.Tensor] = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        else:
            out.append(node)
    walk(tree)
    return out


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`,
    which share its structure); the structure is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def flatten_params(params: Any) -> torch.Tensor:
    """Nest -> one flat vector (row-major per leaf, JAX's leaf order)."""
    leaves = tree_leaves(params)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([l.reshape(-1) for l in leaves])


def unflatten_params(template: Any, flat: torch.Tensor) -> Any:
    """Inverse of `flatten_params` given a nest of the same structure and
    shapes; each leaf keeps the template's dtype and device."""
    leaves = tree_leaves(template)
    n_total = sum(l.numel() for l in leaves)
    if flat.shape[0] != n_total:
        raise ValueError(f"Flat vector length {flat.shape[0]} != params "
                         f"size {n_total}")
    it = iter(torch.split(flat, [l.numel() for l in leaves]))

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):        # JAX's order: sorted keys
            done = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(x) for x in node)
        return next(it).reshape(node.shape).to(node.device, node.dtype,
                                               copy=True)
    return rebuild(template)


def num_params(params: Any) -> int:
    return sum(l.numel() for l in tree_leaves(params))
