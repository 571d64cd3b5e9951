"""NeuralNetConfiguration builder + MultiLayerConfiguration (counterpart of
nn/conf/configuration.py).

Configurations are pure data with the JAX package's JSON schema, so
`MultiLayerConfiguration.from_json(jax_conf.to_json())` builds the same
layer stack here. The global updater is kept as its serialized dict
(`get_updater()` builds the updater object from it, as the JAX package
does). `ListBuilder.build` and `GraphBuilder.build` run the JAX package's
two configuration passes: n_in inference from the running InputType and
automatic preprocessors between layer families (`make_preprocessor`).
"""
from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.common.enums import (Activation, BackpropType,
                                                   ConvolutionMode,
                                                   GradientNormalization,
                                                   OptimizationAlgorithm,
                                                   WeightInit)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor, FeedForwardToRnnPreProcessor,
    InputPreProcessor, RnnToFeedForwardPreProcessor)
from deeplearning4j_tpu_torch.nn.updater.updaters import (BaseUpdater, Sgd,
                                                          updater_from_name)

# Which input kind each layer family expects (None: accepts anything
# as-is), the JAX package's table.
_EXPECTED_KIND = {
    "DenseLayer": "ff", "OutputLayer": "ff", "EmbeddingLayer": "ff",
    "AutoEncoder": "ff", "CenterLossOutputLayer": "ff",
    "VariationalAutoencoder": "ff", "RBM": "ff",
    "ConvolutionLayer": "cnn", "SubsamplingLayer": "cnn",
    "ZeroPaddingLayer": "cnn", "LocalResponseNormalization": "cnn",
    "SpaceToDepthLayer": "cnn", "Upsampling2D": "cnn",
    "DepthwiseConvolutionLayer": "cnn", "SeparableConvolution2D": "cnn",
    "Deconvolution2D": "cnn", "Cropping2D": "cnn",
    "LSTM": "rnn", "GravesLSTM": "rnn", "GravesBidirectionalLSTM": "rnn",
    "RnnOutputLayer": "rnn", "Convolution1DLayer": "rnn",
    "Subsampling1DLayer": "rnn", "SimpleRnn": "rnn", "Bidirectional": "rnn",
    "LastTimeStep": "rnn",
}


def make_preprocessor(from_type: InputType,
                      to_kind: str) -> Optional[InputPreProcessor]:
    """The preprocessor between an input of `from_type` and a layer that
    expects `to_kind`, or None when none is needed."""
    fk = from_type.kind
    if fk == to_kind or (fk == "cnn_flat" and to_kind == "ff"):
        return None
    if fk == "cnn" and to_kind == "ff":
        return CnnToFeedForwardPreProcessor(from_type.height, from_type.width,
                                            from_type.channels)
    if fk == "ff" and to_kind == "cnn":
        raise ValueError("Cannot infer CNN dims from FF input; set an "
                         "explicit FeedForwardToCnnPreProcessor")
    if fk == "cnn_flat" and to_kind == "cnn":
        return FeedForwardToCnnPreProcessor(from_type.height, from_type.width,
                                            from_type.channels)
    if fk == "rnn" and to_kind == "ff":
        return RnnToFeedForwardPreProcessor()
    if fk == "ff" and to_kind == "rnn":
        return FeedForwardToRnnPreProcessor()
    if fk == "cnn" and to_kind == "rnn":
        return CnnToRnnPreProcessor(from_type.height, from_type.width,
                                    from_type.channels)
    if fk == "rnn" and to_kind == "cnn":
        raise ValueError("rnn->cnn requires explicit RnnToCnnPreProcessor "
                         "dims")
    return None


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
                 pretrain: bool = False, backprop: bool = True,
                 preprocessors: Optional[Dict[int, InputPreProcessor]] = None):
        self.layers = layers
        self.preprocessors: Dict[int, InputPreProcessor] = \
            dict(preprocessors or {})
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
            "preprocessors": {str(k): v.to_dict()
                              for k, v in self.preprocessors.items()},
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
        return MultiLayerConfiguration(
            layers=[BaseLayerConf.from_dict(x) for x in d["layers"]],
            global_conf=GlobalConf.from_dict(d["global_conf"]),
            input_type=InputType.from_dict(d["input_type"])
            if d.get("input_type") else None,
            backprop_type=BackpropType(d.get("backprop_type", "standard")),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True),
            preprocessors={int(k): InputPreProcessor.from_dict(v) for k, v
                           in (d.get("preprocessors") or {}).items()})

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def get_updater(self) -> BaseUpdater:
        """The global updater (Sgd() when none is set)."""
        if self.global_conf.updater is None:
            return Sgd()
        return BaseUpdater.from_dict(self.global_conf.updater)

    def input_types_per_layer(self) -> List[InputType]:
        """InputType *into* each layer (after its preprocessor)."""
        if self.input_type is None:
            raise ValueError("Configuration has no input type set")
        cur = self.input_type
        result = []
        for i, layer in enumerate(self.layers):
            if i in self.preprocessors:
                cur = self.preprocessors[i].get_output_type(cur)
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
            """The global updater, kept as its serialized dict: an updater
            object (the port's or anything with `to_dict()`), a dict, or a
            DL4J updater name ("adam", ...) at the builder's learning
            rate."""
            if isinstance(u, str):
                lr = self._layer_defaults.get("learning_rate", 0.1)
                u = updater_from_name(u, learning_rate=lr)
            self._global.updater = dict(u) if isinstance(u, dict) \
                else u.to_dict()
            return self

        def learning_rate(self, lr: float):
            self._layer_defaults["learning_rate"] = float(lr)
            if self._global.updater is not None:
                self._global.updater["learning_rate"] = float(lr)
            return self
        learningRate = learning_rate

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

        def l1(self, v: float):
            self._layer_defaults["l1"] = float(v)
            return self

        def l2(self, v: float):
            self._layer_defaults["l2"] = float(v)
            return self

        def convolution_mode(self, m):
            self._layer_defaults["convolution_mode"] = \
                ConvolutionMode(m) if isinstance(m, str) else m
            return self
        convolutionMode = convolution_mode

        def gradient_normalization(self, g: GradientNormalization):
            self._layer_defaults["gradient_normalization"] = g
            return self

        def list(self) -> "ListBuilder":
            return ListBuilder(self)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph_configuration import \
                GraphBuilder
            return GraphBuilder(self)
        graphBuilder = graph_builder

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
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop_type = BackpropType.Standard
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, index_or_layer, layer: Optional[BaseLayerConf] = None):
        if layer is None:
            index, layer = len(self._layers), index_or_layer
        else:
            index = int(index_or_layer)
        self._layers[index] = layer
        return self

    def input_pre_processor(self, index: int, pp: InputPreProcessor):
        self._preprocessors[int(index)] = pp
        return self
    inputPreProcessor = input_pre_processor

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self
    setInputType = set_input_type

    def backprop_type(self, t: BackpropType):
        self._backprop_type = t
        return self
    backpropType = backprop_type

    def t_bptt_forward_length(self, n: int):
        self._tbptt_fwd = int(n)
        return self
    tBPTTForwardLength = t_bptt_forward_length

    def t_bptt_backward_length(self, n: int):
        self._tbptt_back = int(n)
        return self
    tBPTTBackwardLength = t_bptt_backward_length

    def build(self) -> MultiLayerConfiguration:
        layers = []
        for i in range(len(self._layers)):
            if i not in self._layers:
                raise ValueError(f"Missing layer index {i}")
            layers.append(self._parent._apply_defaults(self._layers[i]))
        pps = dict(self._preprocessors)
        if self._input_type is not None:
            cur = self._input_type
            if cur.kind == "cnn_flat" and layers \
                    and _EXPECTED_KIND.get(type(layers[0]).__name__) == "cnn" \
                    and 0 not in pps:
                # flat CNN input reshapes to NCHW at layer 0
                pps[0] = FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                                      cur.channels)
            for i, layer in enumerate(layers):
                expected = _EXPECTED_KIND.get(type(layer).__name__)
                if i not in pps and expected is not None:
                    pp = make_preprocessor(cur, expected)
                    if pp is not None:
                        pps[i] = pp
                if i in pps:
                    cur = pps[i].get_output_type(cur)
                layer.set_n_in(cur, override=False)
                cur = layer.get_output_type(cur)
        return MultiLayerConfiguration(
            layers=layers, global_conf=copy.deepcopy(self._parent._global),
            input_type=self._input_type, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back, preprocessors=pps)
