"""Device meshes (counterpart of parallel/mesh.py), for data parallelism
in one process.

The JAX package's mesh is a `jax.sharding.Mesh` whose collectives ride
the chips' interconnect. The port's is an ordered list of `torch.device`s
with an axis name: `ParallelWrapper` keeps one replica on each entry and
takes its collectives as explicit sums in that order. A device may repeat
(several replicas on one card, or on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """A mesh of `num_devices` replicas over the "data" axis. On CUDA (the
    default) they are the first `num_devices` cards, and asking for more
    than there are raises, as the JAX package raises beyond
    `jax.devices()`; None takes every card. `device="cpu"` gives that many
    replicas on the CPU (the counterpart of the JAX tests' forced host
    device count)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * int(num_devices or 1))
    have = torch.cuda.device_count()
    n = int(num_devices or have)
    if n > have:
        raise ValueError(f"Requested {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
