"""RnnOutputLayer (counterpart of nn/conf/layers/recurrent.py).

The LSTM family waits for the port of its kernels (K7-K9 in ROADMAP.md).
Layout is the JAX package's recurrent layout, (batch, size, time).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.common.enums import Activation, LossFunction
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    FeedForwardLayerConf, register_layer)
from deeplearning4j_tpu_torch.nn.losses import (compute_loss,
                                                compute_loss_per_example)


@register_layer
@dataclass
class RnnOutputLayer(FeedForwardLayerConf):
    """Per-timestep dense + loss head over (batch, size, time)."""
    loss_fn: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.SOFTMAX
    has_bias: bool = True

    def is_output_layer(self):
        return True

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.size

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        p = {"W": self._winit(generator, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device)
        return p

    def preout(self, params, x):
        # (batch, size, time) -> (batch, n_out, time)
        z = torch.einsum("bst,so->bot", x, params["W"])
        if self.has_bias:
            z = z + params["b"][None, :, None]
        return z

    def forward(self, params, state, x, *, train=False, mask=None):
        z = self.preout(params, x)
        if self.activation == Activation.SOFTMAX:
            out = torch.softmax(z, dim=1)        # over the feature axis
        else:
            out = self._act(z)
        if mask is not None:
            out = out * mask[:, None, :].to(out.dtype)
        return out, state, mask

    def _score_args(self, params, x, labels, mask):
        """(labels, pre-activations, activation, mask) for the loss, as
        (batch * time, n_out) rows with the feature axis last."""
        z = self.preout(params, x).transpose(1, 2).reshape(-1, self.n_out)
        lab = labels.transpose(1, 2).reshape(-1, self.n_out)
        return lab, z, self.activation, \
            None if mask is None else mask.reshape(-1)

    def compute_score(self, params, x, labels, mask=None):
        """Mean loss over the (batch * time) rows."""
        return compute_loss(self.loss_fn, *self._score_args(
            params, x, labels, mask))

    def compute_score_per_example(self, params, x, labels, mask=None):
        """(batch,) scores: each example's loss summed over its unmasked
        timesteps (the scalar score normalizes by batch * time, so
        mean(per_example) / T == score)."""
        per_bt = compute_loss_per_example(
            self.loss_fn, *self._score_args(params, x, labels, mask))
        return per_bt.reshape(x.shape[0], -1).sum(dim=1)
