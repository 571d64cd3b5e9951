"""Dense, output, embedding, activation, dropout and loss layers
(counterpart of nn/conf/layers/feedforward.py).

DenseLayer and OutputLayer keep the JAX layout, W (n_in, n_out) applied as
`x @ W`; EmbeddingLayer is a row gather of W by integer indices.
AutoEncoder waits for `pretrain` (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.common.enums import Activation, LossFunction
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    BaseLayerConf, FeedForwardLayerConf, register_layer)
from deeplearning4j_tpu_torch.nn.losses import (compute_loss,
                                                compute_loss_per_example)


@register_layer
@dataclass
class DenseLayer(FeedForwardLayerConf):
    """Fully connected layer: act(x @ W + b)."""
    has_bias: bool = True

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        p = {"W": self._winit(generator, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device)
        return p

    def preout(self, params, x):
        z = x @ params["W"]
        return z + params["b"] if self.has_bias else z

    def forward(self, params, state, x, *, train=False, mask=None):
        return self._act(self.preout(params, x)), state, mask


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head; the score consumes the pre-activations so
    softmax + MCXENT stays one fused expression."""
    loss_fn: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.SOFTMAX

    def is_output_layer(self):
        return True

    def compute_score(self, params, x, labels, mask=None):
        return compute_loss(self.loss_fn, labels, self.preout(params, x),
                            self.activation, mask)

    def compute_score_per_example(self, params, x, labels, mask=None):
        return compute_loss_per_example(self.loss_fn, labels,
                                        self.preout(params, x),
                                        self.activation, mask)


@register_layer
@dataclass
class EmbeddingLayer(FeedForwardLayerConf):
    """Index -> vector lookup: input (batch, 1) or (batch,) integer
    indices, a row gather of W (n_in, n_out) plus the bias."""
    has_bias: bool = True

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        p = {"W": self._winit(generator, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device)
        return p

    def forward(self, params, state, x, *, train=False, mask=None):
        idx = x.to(torch.int64)
        if idx.dim() == 2:
            idx = idx[:, 0]
        z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state, mask


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

    def compute_score(self, params, x, labels, mask=None):
        return compute_loss(self.loss_fn, labels, x, self.activation, mask)

    def compute_score_per_example(self, params, x, labels, mask=None):
        return compute_loss_per_example(self.loss_fn, labels, x,
                                        self.activation, mask)


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
    """Dropout as an explicit layer. Its `dropout` field (the retain
    probability) is applied by the network's input-dropout pass in
    training; the layer itself is its activation, in training and at
    inference."""
    dropout: float = 0.5

    def has_params(self):
        return False

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, state, x, *, train=False, mask=None):
        return self._act(x), state, mask
