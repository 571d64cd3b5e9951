"""LeNet (counterpart of models/lenet.py): conv 5x5 (20, ReLU, Same) ->
max-pool 2 -> conv 5x5 (50, ReLU, Same) -> max-pool 2 -> dense (500, ReLU)
-> softmax output; AdaDelta; flat 28x28x1 input reshaped at layer 0."""
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
    ConvolutionLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import (DenseLayer,
                                                                 OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater.updaters import AdaDelta


class LeNet(ZooModel):
    def __init__(self, num_labels: int = 10, seed: int = 123,
                 input_shape=(1, 28, 28), updater=None,
                 dtype: str = "float32", compute_dtype=None):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)
        self.updater = updater or AdaDelta()
        self.dtype = dtype
        self.compute_dtype = compute_dtype

    def conf(self):
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .activation(Activation.IDENTITY)
                .weight_init(WeightInit.XAVIER)
                .updater(self.updater)
                .convolution_mode(ConvolutionMode.Same)
                .dtype(self.dtype)
                .compute_dtype(self.compute_dtype)
                .list()
                .layer(ConvolutionLayer(name="cnn1", n_in=c, n_out=20,
                                        kernel_size=(5, 5), stride=(1, 1),
                                        activation=Activation.RELU))
                .layer(SubsamplingLayer(name="maxpool1",
                                        pooling_type=PoolingType.MAX,
                                        kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(name="cnn2", n_out=50,
                                        kernel_size=(5, 5), stride=(1, 1),
                                        activation=Activation.RELU))
                .layer(SubsamplingLayer(name="maxpool2",
                                        pooling_type=PoolingType.MAX,
                                        kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(name="ffn1", n_out=500,
                                  activation=Activation.RELU))
                .layer(OutputLayer(name="output", n_out=self.num_labels,
                                   loss_fn=LossFunction.MCXENT,
                                   activation=Activation.SOFTMAX))
                .set_input_type(InputType.convolutional_flat(h, w, c))
                .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()
