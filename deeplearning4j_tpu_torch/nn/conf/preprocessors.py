"""Input preprocessors: shape adapters between layer families (counterpart
of nn/conf/preprocessors.py). Each is a reshape or transpose; autograd
gives the backward.

Layouts: FF (batch, size); CNN (batch, c, h, w); RNN (batch, size, time).
Each serializes to a dict with an "@class" discriminator and the JAX
package's field names.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

PREPROCESSOR_REGISTRY: Dict[str, type] = {}


def register_preprocessor(cls):
    PREPROCESSOR_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class InputPreProcessor:
    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def feed_forward_mask(self, mask, minibatch_size=None):
        return mask

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputPreProcessor":
        d = dict(d)
        cls = PREPROCESSOR_REGISTRY[d.pop("@class")]
        if "processors" in d:
            d["processors"] = tuple(
                InputPreProcessor.from_dict(p) if isinstance(p, dict) else p
                for p in d["processors"])
        for k, v in list(d.items()):
            if isinstance(v, list):
                d[k] = tuple(v)
        return cls(**d)


@register_preprocessor
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x):
        return x.reshape(x.shape[0], -1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.flat_size())


@register_preprocessor
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 1

    def preprocess(self, x):
        if x.dim() == 4:
            return x
        return x.reshape(x.shape[0], self.channels, self.height, self.width)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_preprocessor
@dataclass
class TensorFlowCnnToFeedForwardPreProcessor(CnnToFeedForwardPreProcessor):
    """Flatten NCHW activations in channels-last (h, w, c) element order,
    the order a TensorFlow-backend Keras `Flatten` produced."""

    def preprocess(self, x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


@register_preprocessor
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(batch, size, time) -> (batch * time, size), timesteps stacked."""

    def preprocess(self, x):
        return x.transpose(1, 2).reshape(-1, x.shape[1])

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)

    def feed_forward_mask(self, mask, minibatch_size=None):
        return None if mask is None else mask.reshape(-1)


@register_preprocessor
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(batch * time, size) -> (batch, size, time); the network passes the
    original minibatch size at call time."""
    minibatch: int = 0

    def preprocess(self, x, minibatch: Optional[int] = None):
        b = minibatch or self.minibatch
        return x.reshape(b, x.shape[0] // b, x.shape[1]).transpose(1, 2)

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.size)


@register_preprocessor
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x):
        return x.reshape(x.shape[0], -1)

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.flat_size())


@register_preprocessor
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 1

    def preprocess(self, x):
        b, s, t = x.shape
        return x.transpose(1, 2).reshape(b * t, self.channels, self.height,
                                         self.width)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_preprocessor
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    processors: tuple = ()

    def preprocess(self, x):
        for p in self.processors:
            x = p.preprocess(x)
        return x

    def get_output_type(self, input_type):
        for p in self.processors:
            input_type = p.get_output_type(input_type)
        return input_type

    def to_dict(self):
        return {"@class": type(self).__name__,
                "processors": [p.to_dict() for p in self.processors]}


def apply_preprocessor(pp: InputPreProcessor, x, mask, minibatch: int):
    """(x, mask) through `pp`; FeedForwardToRnn takes the minibatch."""
    if isinstance(pp, FeedForwardToRnnPreProcessor):
        x = pp.preprocess(x, minibatch=minibatch)
    else:
        x = pp.preprocess(x)
    return x, pp.feed_forward_mask(mask, minibatch)
