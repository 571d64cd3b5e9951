"""Activation functions on tensors (counterpart of nn/activations.py).

Each entry computes the same function as the JAX package's: SOFTMAX runs
over the last axis, GELU is the tanh approximation (jax.nn.gelu's default)
and HARDSIGMOID is relu6(x + 3) / 6 (jax.nn.hard_sigmoid).
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.enums import Activation

TensorFn = Callable[[torch.Tensor], torch.Tensor]

_ACTIVATIONS: dict = {
    Activation.IDENTITY: lambda x: x,
    Activation.RELU: torch.relu,
    Activation.RELU6: lambda x: torch.clamp(x, 0.0, 6.0),
    Activation.LEAKYRELU: lambda x: F.leaky_relu(x, negative_slope=0.01),
    Activation.TANH: torch.tanh,
    Activation.SIGMOID: torch.sigmoid,
    Activation.HARDSIGMOID: F.hardsigmoid,
    Activation.HARDTANH: lambda x: torch.clamp(x, -1.0, 1.0),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
    Activation.SOFTPLUS: F.softplus,
    Activation.SOFTSIGN: F.softsign,
    Activation.ELU: F.elu,
    Activation.SELU: F.selu,
    Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
    Activation.SWISH: F.silu,
    Activation.CUBE: lambda x: x ** 3,
    Activation.RATIONALTANH: lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    Activation.RECTIFIEDTANH: lambda x: torch.clamp(torch.tanh(x), min=0.0),
}


def get_activation(act: Union[Activation, str, None]) -> TensorFn:
    if act is None:
        return _ACTIVATIONS[Activation.IDENTITY]
    if isinstance(act, str):
        act = Activation(act.lower())
    return _ACTIVATIONS[act]


def apply_activation(act, x: torch.Tensor) -> torch.Tensor:
    return get_activation(act)(x)
