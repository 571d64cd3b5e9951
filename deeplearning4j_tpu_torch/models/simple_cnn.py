"""SimpleCNN and TextGenerationLSTM (counterpart of models/simple_cnn.py).

SimpleCNN: Same-mode conv/BN blocks (7x7-16 x2, 5x5-32 x2, 3x3-64 x2,
3x3-128 x2, 3x3-256 + 3x3-num_labels), ReLU ActivationLayers, AVG pools and
Dropout between blocks, a GlobalPooling(AVG) head and a LossLayer(MCXENT,
softmax). A MultiLayerNetwork of 7x7, 5x5 and 3x3 convolutions: it never
reaches K10, which only a ComputationGraph's 1x1 conv -> BN pairs take.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.common.enums import (Activation, BackpropType,
                                                   ConvolutionMode,
                                                   LossFunction, PoolingType,
                                                   WeightInit)
from deeplearning4j_tpu_torch.models.zoo_model import ZooModel
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
    ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import (
    ActivationLayer, DropoutLayer, LossLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (GravesLSTM,
                                                               RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater.updaters import AdaDelta, RmsProp


class SimpleCNN(ZooModel):
    def __init__(self, num_labels: int = 10, seed: int = 123,
                 input_shape=(3, 48, 48), updater=None,
                 dtype: str = "float32", compute_dtype=None):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)
        self.updater = updater or AdaDelta()
        self.dtype = dtype
        self.compute_dtype = compute_dtype

    def conf(self):
        c, h, w = self.input_shape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .activation(Activation.IDENTITY)
             .weight_init(WeightInit.RELU)
             .updater(self.updater)
             .convolution_mode(ConvolutionMode.Same)
             .dtype(self.dtype)
             .compute_dtype(self.compute_dtype)
             .list())

        def block(k, width, pool=True, first=None):
            b.layer(first or ConvolutionLayer(n_out=width,
                                              kernel_size=(k, k)))
            b.layer(BatchNormalization())
            b.layer(ConvolutionLayer(n_out=width, kernel_size=(k, k)))
            b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation=Activation.RELU))
            if pool:
                b.layer(SubsamplingLayer(pooling_type=PoolingType.AVG,
                                         kernel_size=(2, 2), stride=(2, 2)))
                b.layer(DropoutLayer(dropout=0.5))

        block(7, 16, first=ConvolutionLayer(name="image_array", n_in=c,
                                            n_out=16, kernel_size=(7, 7)))
        block(5, 32)
        block(3, 64)
        block(3, 128)
        b.layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3)))
        b.layer(BatchNormalization())
        b.layer(ConvolutionLayer(n_out=self.num_labels, kernel_size=(3, 3)))
        b.layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
        b.layer(LossLayer(loss_fn=LossFunction.MCXENT,
                          activation=Activation.SOFTMAX))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()

    def init(self, device="cuda") -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()


class TextGenerationLSTM(ZooModel):
    """The char-RNN: GravesLSTM(256) x2 -> RnnOutputLayer(MCXENT softmax),
    truncated BPTT 50/50, RmsProp lr 0.01, l2 1e-3, XAVIER init, no
    gradient clipping. conf() gives the JAX package's JSON."""

    def __init__(self, total_unique_characters: int = 47, seed: int = 123,
                 max_length: int = 40, updater=None, dtype: str = "float32",
                 compute_dtype=None):
        super().__init__(total_unique_characters, seed)
        self.max_length = max_length
        self.updater = updater
        self.dtype = dtype
        self.compute_dtype = compute_dtype

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .l2(0.001)
                .weight_init(WeightInit.XAVIER)
                .updater(self.updater or RmsProp(learning_rate=0.01))
                .dtype(self.dtype)
                .compute_dtype(self.compute_dtype)
                .list()
                .layer(GravesLSTM(n_in=self.num_labels, n_out=256,
                                  activation=Activation.TANH))
                .layer(GravesLSTM(n_out=256, activation=Activation.TANH))
                .layer(RnnOutputLayer(n_out=self.num_labels,
                                      loss_fn=LossFunction.MCXENT,
                                      activation=Activation.SOFTMAX))
                .set_input_type(InputType.recurrent(self.num_labels))
                .backprop_type(BackpropType.TruncatedBPTT)
                .t_bptt_forward_length(50)
                .t_bptt_backward_length(50)
                .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
