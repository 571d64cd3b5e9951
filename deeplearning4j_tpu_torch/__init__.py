"""PyTorch + CUDA port of deeplearning4j_tpu, for one NVIDIA H100.

The package mirrors the JAX package's module paths (``nn/conf``,
``nn/multilayer.py``, ``ops``, ``serving``, ``telemetry``) so each module
has an obvious counterpart, and uses PyTorch idiom inside: plain functions
on tensors, an explicit ``device`` argument and an explicit
``torch.Generator`` for every random draw.

Entry points (``MultiLayerNetwork``, ``ComputationGraph``, ``StackDecoder``,
``ServingEngine``, ``parallel.make_mesh``) default to ``device="cuda"`` and
raise when CUDA is absent; they never drop to the CPU on their own, and a
``ParallelWrapper``'s replicas sit where its mesh puts them (by default on
the wrapped network's device type). Pass ``device="cpu"`` to run the plain
PyTorch versions of every kernel (the CPU tests do).

This package imports nothing of JAX and nothing of ``deeplearning4j_tpu``.
"""
from deeplearning4j_tpu_torch.common.enums import (Activation,
                                                   ConvolutionMode,
                                                   LossFunction, PoolingType,
                                                   WeightInit)
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.attention import \
    SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.conf.graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
    ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import (
    ActivationLayer, DenseLayer, DropoutLayer, EmbeddingLayer, LossLayer,
    OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
    LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep,
    RnnOutputLayer, SimpleRnn)
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.parallel import (BasicGradientsAccumulator,
                                               EncodedGradientsAccumulator,
                                               ParallelWrapper, TrainingMode)

__all__ = [
    "Activation", "ConvolutionMode", "LossFunction", "PoolingType",
    "WeightInit", "MultiLayerConfiguration", "ComputationGraphConfiguration",
    "NeuralNetConfiguration", "InputType", "SelfAttentionLayer",
    "ActivationLayer", "DenseLayer", "DropoutLayer", "EmbeddingLayer",
    "LossLayer", "OutputLayer", "ConvolutionLayer", "SubsamplingLayer",
    "ZeroPaddingLayer", "GlobalPoolingLayer", "BatchNormalization",
    "ElementWiseVertex", "RnnOutputLayer", "LSTM", "GravesLSTM",
    "GravesBidirectionalLSTM", "SimpleRnn", "Bidirectional", "LastTimeStep",
    "MultiLayerNetwork", "ComputationGraph", "DataSet", "MultiDataSet",
    "ParallelWrapper", "TrainingMode", "BasicGradientsAccumulator",
    "EncodedGradientsAccumulator",
]
