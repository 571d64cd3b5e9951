"""NeuralNetConfiguration builder + MultiLayerConfiguration (counterpart of
nn/conf/configuration.py).

Configurations are pure data with the JAX package's JSON schema, so
`MultiLayerConfiguration.from_json(jax_conf.to_json())` builds the same
layer stack here. Two parts are not ported yet and raise instead of being
dropped: input preprocessors (no layer of this slice needs one) and
updater objects (the global updater is carried as its serialized dict; the
updaters themselves come with the training slice).
"""
from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.common.enums import (Activation, BackpropType,
                                                   GradientNormalization,
                                                   OptimizationAlgorithm,
                                                   WeightInit)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf

# Which input kind each ported layer family expects (None: accepts anything
# as-is). A stack whose input kinds disagree would need a preprocessor.
_EXPECTED_KIND = {"RnnOutputLayer": "rnn"}


@dataclass
class GlobalConf:
    """Network-wide defaults and settings, the JAX package's GlobalConf field
    for field."""
    seed: int = 12345
    optimization_algo: OptimizationAlgorithm = \
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    updater: Optional[dict] = None
    max_num_line_search_iterations: int = 5
    mini_batch: bool = True
    minimize: bool = True
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    remat: bool = False

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["optimization_algo"] = self.optimization_algo.value
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        d["optimization_algo"] = OptimizationAlgorithm(
            d.get("optimization_algo", "sgd"))
        return GlobalConf(**d)


class MultiLayerConfiguration:
    """Ordered layer stack + training-time settings."""

    def __init__(self, layers: List[BaseLayerConf], global_conf: GlobalConf,
                 input_type: Optional[InputType] = None,
                 backprop_type: BackpropType = BackpropType.Standard,
                 tbptt_fwd_length: int = 20, tbptt_back_length: int = 20,
                 pretrain: bool = False, backprop: bool = True):
        self.layers = layers
        self.preprocessors: Dict[int, Any] = {}
        self.global_conf = global_conf
        self.input_type = input_type
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.pretrain = pretrain
        self.backprop = backprop

    def to_dict(self) -> dict:
        return {
            "layers": [l.to_dict() for l in self.layers],
            "preprocessors": {},
            "global_conf": self.global_conf.to_dict(),
            "input_type": self.input_type.to_dict() if self.input_type
            else None,
            "backprop_type": self.backprop_type.value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "pretrain": self.pretrain,
            "backprop": self.backprop,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        if d.get("preprocessors"):
            raise NotImplementedError(
                "input preprocessors are not ported yet; the configuration "
                f"has {sorted(d['preprocessors'])}")
        return MultiLayerConfiguration(
            layers=[BaseLayerConf.from_dict(x) for x in d["layers"]],
            global_conf=GlobalConf.from_dict(d["global_conf"]),
            input_type=InputType.from_dict(d["input_type"])
            if d.get("input_type") else None,
            backprop_type=BackpropType(d.get("backprop_type", "standard")),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True))

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def input_types_per_layer(self) -> List[InputType]:
        """InputType *into* each layer."""
        if self.input_type is None:
            raise ValueError("Configuration has no input type set")
        cur = self.input_type
        result = []
        for layer in self.layers:
            result.append(cur)
            cur = layer.get_output_type(cur)
        return result


class NeuralNetConfiguration:
    """Namespace matching the reference entry point:
    NeuralNetConfiguration.Builder()...list()...build()."""

    class Builder:
        def __init__(self):
            self._global = GlobalConf()
            self._layer_defaults: Dict[str, Any] = {}

        def seed(self, s: int):
            self._global.seed = int(s)
            return self

        def updater(self, u):
            """The global updater as its serialized dict (a dict, or an
            object with `to_dict()`); carried as data until the training
            slice ports the updaters."""
            self._global.updater = dict(u) if isinstance(u, dict) \
                else u.to_dict()
            return self

        def dtype(self, dt: str):
            self._global.dtype = dt
            return self

        def compute_dtype(self, dt: Optional[str]):
            self._global.compute_dtype = dt
            return self

        def activation(self, a):
            self._layer_defaults["activation"] = \
                Activation(a) if isinstance(a, str) else a
            return self

        def weight_init(self, w):
            self._layer_defaults["weight_init"] = \
                WeightInit(w) if isinstance(w, str) else w
            return self
        weightInit = weight_init

        def dist(self, d: dict):
            self._layer_defaults["dist"] = d
            return self

        def bias_init(self, b: float):
            self._layer_defaults["bias_init"] = float(b)
            return self

        def gradient_normalization(self, g: GradientNormalization):
            self._layer_defaults["gradient_normalization"] = g
            return self

        def list(self) -> "ListBuilder":
            return ListBuilder(self)

        def _apply_defaults(self, layer: BaseLayerConf) -> BaseLayerConf:
            layer = copy.deepcopy(layer)
            explicit = getattr(layer, "_explicit", set())
            for k, v in self._layer_defaults.items():
                if hasattr(layer, k) and k not in explicit:
                    setattr(layer, k, copy.deepcopy(v))
            return layer


class ListBuilder:
    """Sequential-network builder: n_in inference from the running
    InputType, as in the JAX package."""

    def __init__(self, parent: NeuralNetConfiguration.Builder):
        self._parent = parent
        self._layers: Dict[int, BaseLayerConf] = {}
        self._input_type: Optional[InputType] = None

    def layer(self, index_or_layer, layer: Optional[BaseLayerConf] = None):
        if layer is None:
            index, layer = len(self._layers), index_or_layer
        else:
            index = int(index_or_layer)
        self._layers[index] = layer
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self
    setInputType = set_input_type

    def build(self) -> MultiLayerConfiguration:
        layers = []
        for i in range(len(self._layers)):
            if i not in self._layers:
                raise ValueError(f"Missing layer index {i}")
            layers.append(self._parent._apply_defaults(self._layers[i]))
        if self._input_type is not None:
            cur = self._input_type
            for i, layer in enumerate(layers):
                expected = _EXPECTED_KIND.get(type(layer).__name__)
                if expected is not None and cur.kind != expected:
                    raise NotImplementedError(
                        f"layer {i} ({type(layer).__name__}) expects "
                        f"{expected!r} input but receives {cur.kind!r}: "
                        "input preprocessors are not ported yet")
                layer.set_n_in(cur, override=False)
                cur = layer.get_output_type(cur)
        return MultiLayerConfiguration(
            layers=layers, global_conf=copy.deepcopy(self._parent._global),
            input_type=self._input_type)
