"""Weight initialization (counterpart of nn/weights.py).

Same schemes and the same scales as the JAX package, drawn from an explicit
``torch.Generator``. The numbers differ from jax.random's for the same
seed; a test that compares the two packages carries the JAX parameters over
with ``deeplearning4j_tpu_torch.convert.params_from_jax``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from deeplearning4j_tpu_torch.common.enums import WeightInit


def init_weights(shape: Sequence[int], fan_in: float, fan_out: float,
                 weight_init, generator: torch.Generator,
                 distribution: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32,
                 device="cpu") -> torch.Tensor:
    """A (shape) tensor under `weight_init`. The draw is made on the
    generator's device and then moved to `device`, so one CPU generator
    gives the same weights on every device."""
    if isinstance(weight_init, str):
        weight_init = WeightInit(weight_init.lower())
    shape = tuple(int(s) for s in shape)
    fi, fo = float(fan_in), float(fan_out)
    gdev = generator.device

    def normal(std, mean=0.0):
        w = torch.randn(shape, generator=generator, dtype=dtype, device=gdev)
        return (mean + std * w).to(device)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=gdev)
        return (lo + (hi - lo) * u).to(device)

    w = weight_init
    if w == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype, device=device)
    if w == WeightInit.ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if w == WeightInit.IDENTITY:
        if len(shape) == 2 and shape[0] == shape[1]:
            return torch.eye(shape[0], dtype=dtype, device=device)
        raise ValueError("IDENTITY weight init requires square 2d shape")
    if w == WeightInit.NORMAL:
        return normal(1.0 / math.sqrt(max(fi, 1.0)))
    if w == WeightInit.LECUN_NORMAL:
        return normal(math.sqrt(1.0 / max(fi, 1.0)))
    if w == WeightInit.LECUN_UNIFORM:
        a = math.sqrt(3.0 / max(fi, 1.0))
        return uniform(-a, a)
    if w == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(max(fi, 1.0))
        return uniform(-a, a)
    if w in (WeightInit.XAVIER, WeightInit.XAVIER_LEGACY):
        return normal(math.sqrt(2.0 / max(fi + fo, 1.0)))
    if w == WeightInit.XAVIER_UNIFORM:
        a = math.sqrt(6.0 / max(fi + fo, 1.0))
        return uniform(-a, a)
    if w == WeightInit.XAVIER_FAN_IN:
        return normal(math.sqrt(1.0 / max(fi, 1.0)))
    if w == WeightInit.RELU:
        return normal(math.sqrt(2.0 / max(fi, 1.0)))
    if w == WeightInit.RELU_UNIFORM:
        a = math.sqrt(6.0 / max(fi, 1.0))
        return uniform(-a, a)
    if w == WeightInit.SIGMOID_UNIFORM:
        a = 4.0 * math.sqrt(6.0 / max(fi + fo, 1.0))
        return uniform(-a, a)
    if w == WeightInit.DISTRIBUTION:
        d = distribution or {}
        kind = str(d.get("type", "normal")).lower()
        if kind in ("normal", "gaussian"):
            return normal(float(d.get("std", d.get("stddev", 1.0))),
                          float(d.get("mean", 0.0)))
        if kind == "uniform":
            return uniform(float(d.get("lower", -1.0)),
                           float(d.get("upper", 1.0)))
        raise ValueError(f"Unsupported distribution: {kind}")
    if w in (WeightInit.VAR_SCALING_NORMAL_FAN_IN,
             WeightInit.VAR_SCALING_UNIFORM_FAN_IN):
        scale = max(fi, 1.0)
    elif w in (WeightInit.VAR_SCALING_NORMAL_FAN_OUT,
               WeightInit.VAR_SCALING_UNIFORM_FAN_OUT):
        scale = max(fo, 1.0)
    elif w in (WeightInit.VAR_SCALING_NORMAL_FAN_AVG,
               WeightInit.VAR_SCALING_UNIFORM_FAN_AVG):
        scale = max((fi + fo) / 2.0, 1.0)
    else:
        raise ValueError(f"Unsupported weight init: {w}")
    if "uniform" in w.value:
        a = math.sqrt(3.0 / scale)
        return uniform(-a, a)
    return normal(math.sqrt(1.0 / scale))
