"""Activation functions on tensors (counterpart of nn/activations.py).

Each entry computes the same function as the JAX package's: SOFTMAX runs
over the last axis, GELU is the tanh approximation (jax.nn.gelu's default)
and HARDSIGMOID is relu6(x + 3) / 6 (jax.nn.hard_sigmoid).

The gradients at the kinks are JAX's too. `jnp.clip` and `jnp.maximum`
split the gradient evenly at a tie, as `torch.maximum` / `torch.minimum`
do (`torch.clamp` passes all of it): RELU6 at 0 and 6, HARDTANH at +-1
and RECTIFIEDTANH at 0 give 0.5. LEAKYRELU is `where(x >= 0, ...)`, so 1
at 0. jax.nn.relu6's own rule is zero at both ends, so HARDSIGMOID's
gradient at +-3 is 0 (`F.hardtanh`'s backward excludes its bounds).
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.enums import Activation

TensorFn = Callable[[torch.Tensor], torch.Tensor]


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: min(max(x, lo), hi), the gradient halved at a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))

_ACTIVATIONS: dict = {
    Activation.IDENTITY: lambda x: x,
    Activation.RELU: torch.relu,
    Activation.RELU6: lambda x: _clip(x, 0.0, 6.0),
    Activation.LEAKYRELU: lambda x: torch.where(x >= 0, x, 0.01 * x),
    Activation.TANH: torch.tanh,
    Activation.SIGMOID: torch.sigmoid,
    # relu6(x + 3) / 6 as jax.nn.hard_sigmoid: F.hardsigmoid's backward
    # scales by a float32 1/6, off by ~1e-8 relative in float64
    Activation.HARDSIGMOID: lambda x: F.hardtanh(x + 3.0, 0.0, 6.0) / 6.0,
    Activation.HARDTANH: lambda x: _clip(x, -1.0, 1.0),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
    Activation.SOFTPLUS: F.softplus,
    Activation.SOFTSIGN: F.softsign,
    Activation.ELU: F.elu,
    Activation.SELU: F.selu,
    Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
    Activation.SWISH: F.silu,
    Activation.CUBE: lambda x: x ** 3,
    Activation.RATIONALTANH: lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    Activation.RECTIFIEDTANH: lambda x: torch.maximum(torch.tanh(x),
                                                      x.new_tensor(0.0)),
}


def get_activation(act: Union[Activation, str, None]) -> TensorFn:
    if act is None:
        return _ACTIVATIONS[Activation.IDENTITY]
    if isinstance(act, str):
        act = Activation(act.lower())
    return _ACTIVATIONS[act]


def apply_activation(act, x: torch.Tensor) -> torch.Tensor:
    return get_activation(act)(x)
