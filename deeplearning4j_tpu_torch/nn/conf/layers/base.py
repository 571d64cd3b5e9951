"""Layer base classes (counterpart of nn/conf/layers/base.py).

A layer is one declarative dataclass (its configuration) whose `forward` is
a plain function of (params, state, x) on tensors. Every layer serializes to
a dict with an "@class" discriminator through LAYER_REGISTRY, with the same
field names and values as the JAX package, so a configuration JSON written
by the JAX package builds the same stack here.
"""
from __future__ import annotations

import dataclasses
import enum
import typing
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.common.enums import (Activation,
                                                   GradientNormalization,
                                                   WeightInit)
from deeplearning4j_tpu_torch.nn.activations import apply_activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.weights import init_weights

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Register for serde AND wrap __init__ to record explicitly-passed
    kwargs, so the builder's global defaults apply only to fields the user
    did not set (the JAX package's NeuralNetConfiguration.Builder
    semantics)."""
    orig_init = cls.__init__
    field_names = [f.name for f in dataclasses.fields(cls)]

    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        explicit = set(kwargs.keys()) | set(field_names[:len(args)])
        object.__setattr__(self, "_explicit", explicit)

    cls.__init__ = __init__
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def _serde_value(v):
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, InputType):
        return {"@input_type": v.to_dict()}
    if isinstance(v, BaseLayerConf):
        return v.to_dict()
    if isinstance(v, (list, tuple)):
        return [_serde_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _serde_value(x) for k, x in v.items()}
    return v


@dataclass
class BaseLayerConf:
    """Common fields, the JAX package's BaseLayerConf field for field. The
    training-only fields (l1/l2, dropout, updater, frozen, gradient
    normalization, weight sharding) are carried as data for the JSON round
    trip; the serving slice reads none of them."""
    name: Optional[str] = None
    activation: Activation = Activation.IDENTITY
    weight_init: WeightInit = WeightInit.XAVIER
    dist: Optional[dict] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: float = 0.0
    updater: Optional[dict] = None
    frozen: bool = False
    gradient_normalization: GradientNormalization = \
        GradientNormalization.NoNormalization
    gradient_normalization_threshold: float = 1.0
    weight_sharding: Optional[Dict[str, Any]] = None

    # ---------------- shape / params ----------------
    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        return None

    def init_params(self, generator: torch.Generator, input_type: InputType,
                    dtype=torch.float32, device="cpu"
                    ) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, input_type: InputType) -> Dict[str, Any]:
        return {}

    # ---------------- compute ----------------
    def forward(self, params: Dict[str, torch.Tensor], state: Dict[str, Any],
                x: torch.Tensor, *, train: bool = False,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any],
                           Optional[torch.Tensor]]:
        """Returns (output, new_state, output_mask)."""
        raise NotImplementedError

    def is_output_layer(self) -> bool:
        return False

    def has_params(self) -> bool:
        return True

    # ---------------- helpers ----------------
    def _act(self, z):
        return apply_activation(self.activation, z)

    def _winit(self, generator, shape, fan_in, fan_out, dtype, device):
        return init_weights(shape, fan_in, fan_out, self.weight_init,
                            generator, distribution=self.dist, dtype=dtype,
                            device=device)

    # ---------------- serde ----------------
    def to_dict(self) -> dict:
        d = {f.name: _serde_value(getattr(self, f.name))
             for f in dataclasses.fields(self)}
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "BaseLayerConf":
        d = dict(d)
        name = d.pop("@class")
        cls = LAYER_REGISTRY.get(name)
        if cls is None:
            raise NotImplementedError(
                f"layer class {name!r} is not ported to deeplearning4j_tpu_"
                f"torch yet (ported: {sorted(LAYER_REGISTRY)})")
        fields = {f.name for f in dataclasses.fields(cls)}
        hints = typing.get_type_hints(cls)
        kwargs = {k: _deserde_value(hints.get(k), v)
                  for k, v in d.items() if k in fields}
        return cls(**kwargs)


def _deserde_value(hint, v):
    if v is None:
        return None
    if isinstance(v, dict) and "@input_type" in v:
        return InputType.from_dict(v["@input_type"])
    if isinstance(v, dict) and v.get("@class") in LAYER_REGISTRY:
        return BaseLayerConf.from_dict(v)
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _deserde_value(args[0] if len(args) == 1 else None, v)
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return hint(v)
    if isinstance(v, list):
        return tuple(v) if origin is tuple else [
            _deserde_value(None, x) for x in v]
    return v


@dataclass
class FeedForwardLayerConf(BaseLayerConf):
    """Base for layers with explicit n_in/n_out."""
    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            self.n_in = input_type.flat_size()

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)
