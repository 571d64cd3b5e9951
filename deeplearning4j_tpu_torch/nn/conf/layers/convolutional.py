"""Convolution, pooling, padding and global-pooling layers (counterpart of
nn/conf/layers/convolutional.py).

Layouts are the JAX package's: NCHW activations, OIHW weights. A KxK
convolution is `torch.nn.functional.conv2d` (the JAX package's
`lax.conv_general_dilated`, outside any Pallas kernel); pooling pads with
`F.pad` to the JAX package's explicit (possibly asymmetric) Same pads,
-inf for MAX and 0 otherwise, and AVG divides by the count of real
elements in each window. The shape rules are the JAX package's Strict,
Truncate and Same modes.

Ported: ConvolutionLayer, SubsamplingLayer (MAX, AVG, SUM, PNORM),
ZeroPaddingLayer and GlobalPoolingLayer (masks over time for RNN input).
The 1D, deconvolution, depthwise, separable, upsampling, space-to-depth
and cropping layers wait (ROADMAP.md queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.enums import ConvolutionMode, PoolingType
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    BaseLayerConf, FeedForwardLayerConf, register_layer)


def conv_output_size(in_size: int, k: int, s: int, p: int,
                     mode: ConvolutionMode) -> int:
    if mode == ConvolutionMode.Same:
        return -(-in_size // s)                       # ceil
    out = (in_size + 2 * p - k) // s + 1
    if mode == ConvolutionMode.Strict and (in_size + 2 * p - k) % s != 0:
        raise ValueError(
            f"Strict convolution mode: (in={in_size} + 2*pad={p} - k={k}) "
            f"not divisible by stride {s}")
    return out


def _same_pad(in_size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-in_size // s)
    total = max(0, (out - 1) * s + k - in_size)
    return total // 2, total - total // 2


def _pad_config(h, w, kernel, stride, padding, mode, dilation=(1, 1)):
    """((top, bottom), (left, right)) padding of an (h, w) input."""
    if mode == ConvolutionMode.Same:
        kh = kernel[0] + (kernel[0] - 1) * (dilation[0] - 1)
        kw = kernel[1] + (kernel[1] - 1) * (dilation[1] - 1)
        return _same_pad(h, kh, stride[0]), _same_pad(w, kw, stride[1])
    return (padding[0], padding[0]), (padding[1], padding[1])


def _pad_hw(x, ph, pw, value=0.0):
    if not any(ph) and not any(pw):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


@register_layer
@dataclass
class ConvolutionLayer(FeedForwardLayerConf):
    """2D convolution, W (n_out, n_in, kh, kw)."""
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: ConvolutionMode = ConvolutionMode.Truncate
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = True

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.channels

    def get_output_type(self, input_type):
        if input_type.kind != "cnn":
            raise ValueError(
                f"ConvolutionLayer expects CNN input, got {input_type}")
        kh = self.kernel_size[0] + (self.kernel_size[0] - 1) \
            * (self.dilation[0] - 1)
        kw = self.kernel_size[1] + (self.kernel_size[1] - 1) \
            * (self.dilation[1] - 1)
        oh = conv_output_size(input_type.height, kh, self.stride[0],
                              self.padding[0], self.convolution_mode)
        ow = conv_output_size(input_type.width, kw, self.stride[1],
                              self.padding[1], self.convolution_mode)
        return InputType.convolutional(oh, ow, self.n_out)

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        kh, kw = self.kernel_size
        p = {"W": self._winit(generator, (self.n_out, self.n_in, kh, kw),
                              self.n_in * kh * kw, self.n_out * kh * kw,
                              dtype, device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device)
        return p

    def forward(self, params, state, x, *, train=False, mask=None):
        ph, pw = _pad_config(x.shape[2], x.shape[3], self.kernel_size,
                             self.stride, self.padding,
                             self.convolution_mode, self.dilation)
        if ph[0] == ph[1] and pw[0] == pw[1]:      # symmetric: no copy
            pad = (ph[0], pw[0])
        else:
            x, pad = _pad_hw(x, ph, pw), (0, 0)
        z = F.conv2d(x, params["W"], stride=tuple(self.stride), padding=pad,
                     dilation=tuple(self.dilation))
        if self.has_bias:
            z = z + params["b"][None, :, None, None]
        return self._act(z), state, mask


def _pool(x, pooling_type: PoolingType, kernel, stride, ph, pw,
          pnorm: int = 2):
    """reduce_window over (kh, kw) windows of the padded input."""
    k, s = tuple(kernel), tuple(stride)
    if pooling_type == PoolingType.MAX:
        return F.max_pool2d(_pad_hw(x, ph, pw, float("-inf")), k, s)
    xin = x.abs() ** pnorm if pooling_type == PoolingType.PNORM else x
    r = F.avg_pool2d(_pad_hw(xin, ph, pw), k, s, divisor_override=1)
    if pooling_type == PoolingType.AVG:
        counts = F.avg_pool2d(_pad_hw(torch.ones_like(x[:1, :1]), ph, pw),
                              k, s, divisor_override=1)
        r = r / counts
    elif pooling_type == PoolingType.PNORM:
        r = r ** (1.0 / pnorm)
    return r


@register_layer
@dataclass
class SubsamplingLayer(BaseLayerConf):
    """Spatial pooling: MAX, AVG, SUM or PNORM."""
    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: ConvolutionMode = ConvolutionMode.Truncate
    pnorm: int = 2

    def has_params(self):
        return False

    def get_output_type(self, input_type):
        oh = conv_output_size(input_type.height, self.kernel_size[0],
                              self.stride[0], self.padding[0],
                              self.convolution_mode)
        ow = conv_output_size(input_type.width, self.kernel_size[1],
                              self.stride[1], self.padding[1],
                              self.convolution_mode)
        return InputType.convolutional(oh, ow, input_type.channels)

    def forward(self, params, state, x, *, train=False, mask=None):
        ph, pw = _pad_config(x.shape[2], x.shape[3], self.kernel_size,
                             self.stride, self.padding,
                             self.convolution_mode)
        return _pool(x, self.pooling_type, self.kernel_size, self.stride,
                     ph, pw, self.pnorm), state, mask


@register_layer
@dataclass
class ZeroPaddingLayer(BaseLayerConf):
    """Spatial zero padding (top, bottom, left, right)."""
    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def has_params(self):
        return False

    def get_output_type(self, input_type):
        t, b, l, r = self.pad
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def forward(self, params, state, x, *, train=False, mask=None):
        t, b, l, r = self.pad
        return _pad_hw(x, (t, b), (l, r)), state, mask


@register_layer
@dataclass
class GlobalPoolingLayer(BaseLayerConf):
    """Global pooling over time (RNN input (batch, size, time), honouring a
    (batch, time) mask) or over space (CNN input)."""
    pooling_type: PoolingType = PoolingType.MAX
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self):
        return False

    def get_output_type(self, input_type):
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def forward(self, params, state, x, *, train=False, mask=None):
        if x.dim() == 3:
            dims = (2,)
        elif x.dim() == 4:
            dims = (2, 3)
        else:
            raise ValueError("GlobalPoolingLayer expects rank-3/4 input")
        pt = self.pooling_type
        if mask is not None and x.dim() == 3:
            m = mask[:, None, :].to(x.dtype)              # (batch, 1, time)
            if pt == PoolingType.MAX:
                out = torch.where(m > 0, x, x.new_tensor(float("-inf"))
                                  ).amax(dim=dims)
            elif pt == PoolingType.SUM:
                out = (x * m).sum(dim=dims)
            elif pt == PoolingType.AVG:
                out = (x * m).sum(dim=dims) / torch.clamp(m.sum(dim=dims),
                                                          min=1.0)
            else:
                out = ((x.abs() ** self.pnorm) * m).sum(dim=dims) \
                    ** (1.0 / self.pnorm)
        elif pt == PoolingType.MAX:
            out = x.amax(dim=dims)
        elif pt == PoolingType.SUM:
            out = x.sum(dim=dims)
        elif pt == PoolingType.AVG:
            out = x.mean(dim=dims)
        else:
            out = (x.abs() ** self.pnorm).sum(dim=dims) ** (1.0 / self.pnorm)
        return out, state, None
