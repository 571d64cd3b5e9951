"""PyTorch + CUDA port of deeplearning4j_tpu, for one NVIDIA H100.

The package mirrors the JAX package's module paths (``nn/conf``,
``nn/multilayer.py``, ``ops``, ``serving``, ``telemetry``) so each module
has an obvious counterpart, and uses PyTorch idiom inside: plain functions
on tensors, an explicit ``device`` argument and an explicit
``torch.Generator`` for every random draw.

Entry points (``MultiLayerNetwork``, ``StackDecoder``, ``ServingEngine``)
default to ``device="cuda"`` and raise when CUDA is absent; they never drop
to the CPU on their own. Pass ``device="cpu"`` to run the plain PyTorch
versions of every kernel (the CPU tests do).

This package imports nothing of JAX and nothing of ``deeplearning4j_tpu``.
"""
from deeplearning4j_tpu_torch.common.enums import (Activation, LossFunction,
                                                   WeightInit)
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.attention import \
    SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import (
    ActivationLayer, DropoutLayer, LossLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = [
    "Activation", "LossFunction", "WeightInit", "MultiLayerConfiguration",
    "NeuralNetConfiguration", "InputType", "SelfAttentionLayer",
    "ActivationLayer", "DropoutLayer", "LossLayer", "RnnOutputLayer",
    "MultiLayerNetwork",
]
