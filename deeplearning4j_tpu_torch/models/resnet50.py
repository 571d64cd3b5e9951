"""ResNet50 (counterpart of models/resnet50.py): the JAX package's graph,
node for node and name for name.

Stem zero-pad 3 -> conv 7x7/2 -> BN -> ReLU -> max-pool 3x3/2; stages 2-5
of conv and identity bottleneck blocks with ElementWiseVertex(Add)
shortcuts; a 3x3 max-pool head (stride 2) and a softmax output with NLL
loss. RmsProp(0.1, 0.96), N(0, 0.5) weight init, l1 1e-7, l2 5e-5,
Truncate convolution mode. BN activations are IDENTITY and each ReLU is
its own ActivationLayer, so every block's 1x1 convs 2a and 2c (and a conv
block's branch1 shortcut) feed a BatchNormalization alone: 36 pairs, each
fused through K10 in training.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.common.enums import (Activation,
                                                   ConvolutionMode,
                                                   LossFunction, PoolingType,
                                                   WeightInit)
from deeplearning4j_tpu_torch.models.zoo_model import ZooModel
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
    ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import (
    ActivationLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.updater.updaters import RmsProp


class ResNet50(ZooModel):
    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224), updater=None,
                 dtype: str = "float32", compute_dtype=None):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)
        self.updater = updater or RmsProp(learning_rate=0.1, rms_decay=0.96)
        self.dtype = dtype
        self.compute_dtype = compute_dtype

    def _block(self, g, kernel, filters, stage, block, inp, stride=None):
        """A bottleneck block: 1x1 (2a) -> kxk Same (2b) -> 1x1 (2c), each
        with BN, plus the shortcut: `inp` itself (identity block,
        stride None) or a strided 1x1 conv + BN (conv block, branch1)."""
        conv = f"res{stage}{block}_branch"
        bn = f"bn{stage}{block}_branch"
        act = f"act{stage}{block}_branch"
        short = f"short{stage}{block}_branch"
        relu = ActivationLayer(activation=Activation.RELU)
        first = {} if stride is None else {"stride": stride}
        (g.add_layer(conv + "2a", ConvolutionLayer(
            n_out=filters[0], kernel_size=(1, 1), **first), inp)
          .add_layer(bn + "2a", BatchNormalization(), conv + "2a")
          .add_layer(act + "2a", relu, bn + "2a")
          .add_layer(conv + "2b", ConvolutionLayer(
              n_out=filters[1], kernel_size=kernel,
              convolution_mode=ConvolutionMode.Same), act + "2a")
          .add_layer(bn + "2b", BatchNormalization(), conv + "2b")
          .add_layer(act + "2b", relu, bn + "2b")
          .add_layer(conv + "2c", ConvolutionLayer(
              n_out=filters[2], kernel_size=(1, 1)), act + "2b")
          .add_layer(bn + "2c", BatchNormalization(), conv + "2c"))
        if stride is None:
            g.add_vertex(short, ElementWiseVertex(op="Add"), bn + "2c", inp)
        else:
            (g.add_layer(conv + "1", ConvolutionLayer(
                n_out=filters[2], kernel_size=(1, 1), stride=stride), inp)
              .add_layer(bn + "1", BatchNormalization(), conv + "1")
              .add_vertex(short, ElementWiseVertex(op="Add"), bn + "2c",
                          bn + "1"))
        g.add_layer(conv, relu, short)
        return conv

    def _identity_block(self, g, kernel, filters, stage, block, inp):
        return self._block(g, kernel, filters, stage, block, inp)

    def _conv_block(self, g, kernel, filters, stage, block, inp,
                    stride=(2, 2)):
        return self._block(g, kernel, filters, stage, block, inp, stride)

    def graph_builder(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .activation(Activation.IDENTITY)
             .updater(self.updater)
             .weight_init(WeightInit.DISTRIBUTION)
             .dist({"type": "normal", "mean": 0.0, "std": 0.5})
             .l1(1e-7).l2(5e-5)
             .convolution_mode(ConvolutionMode.Truncate)
             .dtype(self.dtype)
             .compute_dtype(self.compute_dtype)
             .graph_builder())
        relu = ActivationLayer(activation=Activation.RELU)
        (g.add_inputs("input")
          .add_layer("stem-zero", ZeroPaddingLayer(pad=(3, 3, 3, 3)), "input")
          .add_layer("stem-cnn1", ConvolutionLayer(
              n_out=64, kernel_size=(7, 7), stride=(2, 2)), "stem-zero")
          .add_layer("stem-batch1", BatchNormalization(), "stem-cnn1")
          .add_layer("stem-act1", relu, "stem-batch1")
          .add_layer("stem-maxpool1", SubsamplingLayer(
              pooling_type=PoolingType.MAX, kernel_size=(3, 3),
              stride=(2, 2)), "stem-act1"))
        x = "stem-maxpool1"
        for stage, filters, blocks in (("2", (64, 64, 256), "abc"),
                                       ("3", (128, 128, 512), "abcd"),
                                       ("4", (256, 256, 1024), "abcdef"),
                                       ("5", (512, 512, 2048), "abc")):
            x = self._conv_block(g, (3, 3), filters, stage, "a", x)
            for b in blocks[1:]:
                x = self._identity_block(g, (3, 3), filters, stage, b, x)
        # the JAX package's head: MAX 3x3 at the default stride 2 -> 1x1
        (g.add_layer("avgpool", SubsamplingLayer(
            pooling_type=PoolingType.MAX, kernel_size=(3, 3)), x)
          .add_layer("output", OutputLayer(
              n_out=self.num_labels,
              loss_fn=LossFunction.NEGATIVELOGLIKELIHOOD,
              activation=Activation.SOFTMAX), "avgpool")
          .set_outputs("output")
          .set_input_types(InputType.convolutional(h, w, c)))
        return g

    def conf(self):
        return self.graph_builder().build()

    def init(self, device="cuda") -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()
