"""Kernel seam (counterpart of ops/helpers.py `register_helper` /
`helper_for`).

One change of meaning from the JAX package: the device of the tensors
decides, and nothing else does. A CUDA tensor always gets the registered
kernel; a CPU tensor gets the plain PyTorch version. No environment
variable turns a kernel off on the card, and a kernel that fails to build
or launch raises: there is no silent fallback.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_REGISTRY: Dict[str, Callable] = {}


def register_helper(op_name: str):
    """Decorator: register the CUDA kernel wrapper for `op_name`."""
    def deco(fn):
        _REGISTRY[op_name] = fn
        return fn
    return deco


def helper_for(op_name: str, plain: Callable, like: torch.Tensor) -> Callable:
    """The kernel for `op_name` when `like` lies on a CUDA device (raises
    when none is registered), else `plain`."""
    if like.device.type != "cuda":
        return plain
    kernel = _REGISTRY.get(op_name)
    if kernel is None:
        raise RuntimeError(f"no CUDA kernel registered for {op_name!r}")
    return kernel


def registered_helpers() -> Dict[str, Callable]:
    return dict(_REGISTRY)


def tickets(table: dict, n: int, device, stream: int, lib) -> torch.Tensor:
    """Zeroed int32 tickets, at least n, for a kernel whose last CTA of a
    group reduces the group's partials (K1, K2, K6, K8's backward). Every
    launch puts the tickets it takes back to 0, so one buffer serves the
    calls of a stream in order: `table` (the caller's) keeps one per
    (device, stream), and one per CUDA graph capture (`lib.dl4j_capture_id`),
    zeroed by a memset at its first call in the graph. Buffers are kept,
    since a captured graph goes on using its own."""
    key = (device, stream, lib.dl4j_capture_id(stream))
    bufs = table.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 64), dtype=torch.int32,
                                device=device))
    return bufs[-1]
