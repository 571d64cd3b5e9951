"""Input type / shape inference, copied from nn/conf/input_type.py.

Layouts match the JAX package: feed-forward (batch, size), recurrent
(batch, size, time), convolutional (batch, channels, h, w).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnn_flat"
    size: int = 0  # ff size or rnn feature size or cnn channels
    height: int = 0
    width: int = 0
    timeseries_length: int = -1  # -1 = unknown/variable

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType("rnn", size=int(size),
                         timeseries_length=int(timeseries_length))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", size=int(channels), height=int(height),
                         width=int(width))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType("cnn_flat", size=int(channels), height=int(height),
                         width=int(width))

    @property
    def channels(self) -> int:
        return self.size

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        if self.kind in ("cnn", "cnn_flat"):
            return self.size * self.height * self.width
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)

    def example_shape(self, batch: int = 1, time: int = 8) -> tuple:
        """A concrete tensor shape for this input type (variable time ->
        `time`)."""
        if self.kind == "ff":
            return (batch, self.size)
        if self.kind == "rnn":
            t = self.timeseries_length if self.timeseries_length > 0 else time
            return (batch, self.size, t)
        if self.kind == "cnn":
            return (batch, self.size, self.height, self.width)
        if self.kind == "cnn_flat":
            return (batch, self.size * self.height * self.width)
        raise ValueError(self.kind)
