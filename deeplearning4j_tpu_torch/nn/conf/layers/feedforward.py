"""Position-wise parameterless layers (counterpart of
nn/conf/layers/feedforward.py).

Only the layers StackDecoder accepts between attention layers are ported:
ActivationLayer, DropoutLayer and LossLayer. DenseLayer, OutputLayer,
EmbeddingLayer and AutoEncoder wait for the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_tpu_torch.common.enums import Activation, LossFunction
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayerConf,
                                                          register_layer)


@register_layer
@dataclass
class LossLayer(BaseLayerConf):
    """Parameterless loss head; at inference it applies its activation."""
    loss_fn: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.SOFTMAX

    def is_output_layer(self):
        return True

    def has_params(self):
        return False

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, state, x, *, train=False, mask=None):
        return self._act(x), state, mask

    def preout(self, params, x):
        return x


@register_layer
@dataclass
class ActivationLayer(BaseLayerConf):
    """Pure activation."""
    def has_params(self):
        return False

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, state, x, *, train=False, mask=None):
        return self._act(x), state, mask


@register_layer
@dataclass
class DropoutLayer(BaseLayerConf):
    """Dropout as an explicit layer: identity (plus its activation) at
    inference, which is all this slice runs."""
    dropout: float = 0.5

    def has_params(self):
        return False

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, state, x, *, train=False, mask=None):
        if train:
            raise NotImplementedError(
                "training-mode dropout waits for the training slice")
        return self._act(x), state, mask
