"""TextGenerationLSTM (counterpart of models/simple_cnn.py). SimpleCNN,
the other model of that file, waits for the convolutional layers and
their kernel K10 (ROADMAP.md)."""
from __future__ import annotations

from deeplearning4j_tpu_torch.common.enums import (Activation, BackpropType,
                                                   LossFunction, WeightInit)
from deeplearning4j_tpu_torch.models.zoo_model import ZooModel
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (GravesLSTM,
                                                               RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater.updaters import RmsProp


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
