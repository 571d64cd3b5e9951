"""Batch normalization (counterpart of nn/conf/layers/normalization.py).

BatchNormalization normalizes over the features (FF input) or the
channels (NCHW axis 1). Its running mean and variance live in the
network's `state_tree` ({"mean", "var"}, in the network's dtype) and are
blended with the batch statistics in training (decay d: d * running +
(1 - d) * batch); inference normalizes with them. Batch statistics are
the JAX package's: for sub-fp32 inputs one pass in fp32 (E[x^2] - E[x]^2,
clamped at 0), then cast to the input dtype; for fp32/fp64 two passes
(`torch.var` with correction=0, JAX's ddof).
LocalResponseNormalization waits (ROADMAP.md queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    FeedForwardLayerConf, register_layer)


@register_layer
@dataclass
class BatchNormalization(FeedForwardLayerConf):
    """BN over features (FF input) or channels (CNN input)."""
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.size        # channels for CNN, size for FF
        if self.n_out == 0 or override:
            self.n_out = self.n_in

    def get_output_type(self, input_type):
        return input_type

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        if self.lock_gamma_beta:
            return {}
        return {"gamma_w": torch.full((self.n_in,), self.gamma, dtype=dtype,
                                      device=device),
                "beta": torch.full((self.n_in,), self.beta, dtype=dtype,
                                   device=device)}

    def init_state(self, input_type, dtype=torch.float32, device="cpu"):
        return {"mean": torch.zeros((self.n_in,), dtype=dtype,
                                    device=device),
                "var": torch.ones((self.n_in,), dtype=dtype, device=device)}

    def forward(self, params, state, x, *, train=False, mask=None):
        dims = (0, 2, 3) if x.dim() == 4 else (0, 2) if x.dim() == 3 \
            else (0,)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            if x.dtype.itemsize < 4:
                xf = x.float()
                mean32 = xf.mean(dim=dims)
                var32 = torch.clamp((xf * xf).mean(dim=dims)
                                    - mean32 * mean32, min=0.0)
                mean, var = mean32.to(x.dtype), var32.to(x.dtype)
            else:
                mean = x.mean(dim=dims)
                var = x.var(dim=dims, correction=0)
            d = self.decay
            new_state = {"mean": d * state["mean"] + (1 - d) * mean,
                         "var": d * state["var"] + (1 - d) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xhat = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                      + self.eps)
        if self.lock_gamma_beta:
            out = self.gamma * xhat + self.beta
        else:
            out = params["gamma_w"].reshape(shape) * xhat \
                + params["beta"].reshape(shape)
        return self._act(out), new_state, mask
