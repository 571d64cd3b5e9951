"""Graph vertices: the non-layer nodes of a ComputationGraph (counterpart
of nn/graph/vertices.py). A vertex is a parameterless function of its
input tensors and masks; autograd gives its backward. Each serializes to
a dict with an "@class" discriminator and the JAX package's fields.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class GraphVertex:
    def forward(self, inputs: List[torch.Tensor],
                masks: List[Optional[torch.Tensor]]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError

    def get_output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphVertex":
        d = dict(d)
        cls = VERTEX_REGISTRY[d.pop("@class")]
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})


def _first_mask(masks):
    return next((m for m in masks if m is not None), None)


def _like(t: InputType, size: int) -> InputType:
    """`t` with its feature/channel size replaced."""
    if t.kind == "cnn":
        return InputType.convolutional(t.height, t.width, size)
    if t.kind == "rnn":
        return InputType.recurrent(size, t.timeseries_length)
    return InputType.feed_forward(size)


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel axis (axis 1)."""

    def forward(self, inputs, masks):
        return torch.cat(inputs, dim=1), _first_mask(masks)

    def get_output_type(self, input_types):
        return _like(input_types[0], sum(t.size for t in input_types))


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise Add/Subtract/Product/Average/Max of same-shaped
    inputs."""
    op: str = "Add"

    def forward(self, inputs, masks):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op == "subtract":
            out = inputs[0] - inputs[1]
        elif op == "product":
            for x in inputs[1:]:
                out = out * x
        elif op == "average":
            out = sum(inputs) / len(inputs)
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"Unknown ElementWise op {self.op}")
        return out, _first_mask(masks)

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from_idx, to_idx], inclusive."""
    from_idx: int = 0
    to_idx: int = 0

    def forward(self, inputs, masks):
        return inputs[0][:, self.from_idx:self.to_idx + 1], \
            _first_mask(masks)

    def get_output_type(self, input_types):
        return _like(input_types[0], self.to_idx - self.from_idx + 1)


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """Stack along the batch axis."""

    def forward(self, inputs, masks):
        ms = [m for m in masks if m is not None]
        mask = torch.cat(ms, dim=0) if len(ms) == len(inputs) else None
        return torch.cat(inputs, dim=0), mask

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Batch slice `from_idx` of `stack_size` equal chunks."""
    from_idx: int = 0
    stack_size: int = 1

    def forward(self, inputs, masks):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        sl = slice(self.from_idx * step, (self.from_idx + 1) * step)
        m = _first_mask(masks)
        return x[sl], None if m is None else m[sl]

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    scale_factor: float = 1.0

    def forward(self, inputs, masks):
        return inputs[0] * self.scale_factor, _first_mask(masks)

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    shift_factor: float = 0.0

    def forward(self, inputs, masks):
        return inputs[0] + self.shift_factor, _first_mask(masks)

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape to `new_shape`."""
    new_shape: tuple = ()

    def forward(self, inputs, masks):
        return inputs[0].reshape(self.new_shape), _first_mask(masks)

    def get_output_type(self, input_types):
        s = self.new_shape
        if len(s) == 2:
            return InputType.feed_forward(s[1])
        if len(s) == 3:
            return InputType.recurrent(s[1])
        if len(s) == 4:
            return InputType.convolutional(s[2], s[3], s[1])
        raise ValueError(s)


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """Per-example L2 distance between two inputs, (batch, 1)."""
    eps: float = 1e-8

    def forward(self, inputs, masks):
        a = inputs[0].reshape(inputs[0].shape[0], -1)
        b = inputs[1].reshape(inputs[1].shape[0], -1)
        return torch.sqrt(((a - b) ** 2).sum(dim=1) + self.eps)[:, None], \
            None

    def get_output_type(self, input_types):
        return InputType.feed_forward(1)


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    """Each example scaled to unit L2 norm."""
    eps: float = 1e-8

    def forward(self, inputs, masks):
        x = inputs[0]
        norm = torch.sqrt((x.reshape(x.shape[0], -1) ** 2).sum(dim=1)
                          + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.dim() - 1)), \
            _first_mask(masks)

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclass
class PoolHelperVertex(GraphVertex):
    """Drops the first row and column of a CNN activation."""

    def forward(self, inputs, masks):
        return inputs[0][:, :, 1:, 1:], _first_mask(masks)

    def get_output_type(self, input_types):
        t = input_types[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """(batch, size, time) -> (batch, size) at the last unmasked step."""

    def forward(self, inputs, masks):
        x = inputs[0]
        m = _first_mask(masks)
        if m is None:
            return x[:, :, -1], None
        idx = ((m > 0).sum(dim=1) - 1).clamp(0, x.shape[2] - 1)
        idx = idx.to(torch.int64)[:, None, None].expand(-1, x.shape[1], 1)
        return torch.gather(x, 2, idx)[:, :, 0], None

    def get_output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(batch, size) -> (batch, size, time), the time axis taken from the
    second input."""

    def forward(self, inputs, masks):
        x, ref = inputs[0], inputs[1]
        return x[:, :, None].expand(-1, -1, ref.shape[2]), masks[1]

    def get_output_type(self, input_types):
        t = input_types[1].timeseries_length if len(input_types) > 1 else -1
        return InputType.recurrent(input_types[0].size, t)
