"""ComputationGraph configuration and GraphBuilder (counterpart of
nn/conf/graph_configuration.py).

The JSON is the JAX package's, nodes in insertion order, so either
package reads the other's. The topological order is Kahn's sort with the
JAX package's tie rule: the ready queue starts sorted by name, and
dependents join it in node-insertion order. The graph's flat parameter
and updater-state order is this order's layer nodes.
"""
from __future__ import annotations

import copy
import json
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from deeplearning4j_tpu_torch.common.enums import BackpropType
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    _EXPECTED_KIND, GlobalConf, make_preprocessor)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor
from deeplearning4j_tpu_torch.nn.graph.vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.updater.updaters import BaseUpdater, Sgd


@dataclass
class GraphNode:
    name: str
    kind: str                                    # "layer" | "vertex"
    conf: Union[BaseLayerConf, GraphVertex]
    inputs: List[str]
    preprocessor: Optional[InputPreProcessor] = None

    def to_dict(self):
        return {"name": self.name, "kind": self.kind,
                "conf": self.conf.to_dict(), "inputs": list(self.inputs),
                "preprocessor": self.preprocessor.to_dict()
                if self.preprocessor else None}

    @staticmethod
    def from_dict(d):
        conf = (BaseLayerConf.from_dict(d["conf"]) if d["kind"] == "layer"
                else GraphVertex.from_dict(d["conf"]))
        pp = InputPreProcessor.from_dict(d["preprocessor"]) \
            if d.get("preprocessor") else None
        return GraphNode(d["name"], d["kind"], conf, list(d["inputs"]), pp)


class ComputationGraphConfiguration:
    def __init__(self, inputs: List[str], outputs: List[str],
                 nodes: Dict[str, GraphNode], global_conf: GlobalConf,
                 input_types: Optional[List[InputType]] = None,
                 backprop_type: BackpropType = BackpropType.Standard,
                 tbptt_fwd_length: int = 20, tbptt_back_length: int = 20):
        self.inputs = inputs
        self.outputs = outputs
        self.nodes = nodes
        self.global_conf = global_conf
        self.input_types = input_types
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.topo_order = self._topological_sort()

    def _topological_sort(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        dependents: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for name, node in self.nodes.items():
            for inp in node.inputs:
                if inp in self.nodes:
                    indeg[name] += 1
                    dependents[inp].append(name)
                elif inp not in self.inputs:
                    raise ValueError(
                        f"Node '{name}' references unknown input '{inp}'")
        ready = deque(sorted(n for n, d in indeg.items() if d == 0))
        order = []
        while ready:
            n = ready.popleft()
            order.append(n)
            for dep in dependents[n]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    ready.append(dep)
        if len(order) != len(self.nodes):
            cyc = set(self.nodes) - set(order)
            raise ValueError(f"Graph contains a cycle involving: "
                             f"{sorted(cyc)}")
        return order

    def node_input_types(self) -> Dict[str, List[InputType]]:
        """InputTypes flowing into each node (after a layer's
        preprocessor)."""
        if self.input_types is None:
            raise ValueError("Configuration has no input types set")
        known: Dict[str, InputType] = dict(zip(self.inputs, self.input_types))
        result: Dict[str, List[InputType]] = {}
        for name in self.topo_order:
            node = self.nodes[name]
            in_types = [known[i] for i in node.inputs]
            if node.kind == "layer":
                if node.preprocessor is not None:
                    in_types = [node.preprocessor.get_output_type(
                        in_types[0])]
                result[name] = in_types
                known[name] = node.conf.get_output_type(in_types[0])
            else:
                result[name] = in_types
                known[name] = node.conf.get_output_type(in_types)
        return result

    def to_dict(self):
        return {
            "inputs": list(self.inputs), "outputs": list(self.outputs),
            "nodes": {k: v.to_dict() for k, v in self.nodes.items()},
            "global_conf": self.global_conf.to_dict(),
            "input_types": [t.to_dict() for t in self.input_types]
            if self.input_types else None,
            "backprop_type": self.backprop_type.value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "network_type": "ComputationGraph",
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @staticmethod
    def from_dict(d):
        return ComputationGraphConfiguration(
            inputs=list(d["inputs"]), outputs=list(d["outputs"]),
            nodes={k: GraphNode.from_dict(v) for k, v in d["nodes"].items()},
            global_conf=GlobalConf.from_dict(d["global_conf"]),
            input_types=[InputType.from_dict(t) for t in d["input_types"]]
            if d.get("input_types") else None,
            backprop_type=BackpropType(d.get("backprop_type", "standard")),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20))

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def get_updater(self) -> BaseUpdater:
        if self.global_conf.updater is None:
            return Sgd()
        return BaseUpdater.from_dict(self.global_conf.updater)


class GraphBuilder:
    """NeuralNetConfiguration.Builder().graph_builder()."""

    def __init__(self, parent):
        self._parent = parent
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: Dict[str, GraphNode] = {}
        self._input_types: Optional[List[InputType]] = None
        self._backprop_type = BackpropType.Standard
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str):
        self._inputs.extend(names)
        return self
    addInputs = add_inputs

    def add_layer(self, name: str, layer: BaseLayerConf, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None):
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"Duplicate node name '{name}'")
        layer = self._parent._apply_defaults(layer)
        layer.name = name
        self._nodes[name] = GraphNode(name, "layer", layer, list(inputs),
                                      preprocessor)
        return self
    addLayer = add_layer

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"Duplicate node name '{name}'")
        self._nodes[name] = GraphNode(name, "vertex", vertex, list(inputs))
        return self
    addVertex = add_vertex

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self
    setOutputs = set_outputs

    def set_input_types(self, *types: InputType):
        self._input_types = list(types)
        return self
    setInputTypes = set_input_types

    def backprop_type(self, t: BackpropType):
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int):
        self._tbptt_fwd = int(n)
        return self

    def t_bptt_backward_length(self, n: int):
        self._tbptt_back = int(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = ComputationGraphConfiguration(
            inputs=list(self._inputs), outputs=list(self._outputs),
            nodes=self._nodes, global_conf=copy.deepcopy(self._parent._global),
            input_types=self._input_types, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back)
        gc = conf.global_conf
        if gc.updater is None and "learning_rate" in \
                self._parent._layer_defaults:
            gc.updater = Sgd(learning_rate=self._parent._layer_defaults[
                "learning_rate"]).to_dict()
        for out in conf.outputs:
            if out not in conf.nodes:
                raise ValueError(f"Output '{out}' is not a node in the graph")
        if conf.input_types is not None:
            if len(conf.input_types) != len(conf.inputs):
                raise ValueError("setInputTypes count must match addInputs "
                                 "count")
            # automatic preprocessors and n_in inference, in topo order
            known = dict(zip(conf.inputs, conf.input_types))
            for name in conf.topo_order:
                node = conf.nodes[name]
                in_types = [known[i] for i in node.inputs]
                if node.kind == "layer":
                    cur = in_types[0]
                    expected = _EXPECTED_KIND.get(type(node.conf).__name__)
                    if node.preprocessor is None and expected is not None:
                        node.preprocessor = make_preprocessor(cur, expected)
                    if node.preprocessor is not None:
                        cur = node.preprocessor.get_output_type(cur)
                    node.conf.set_n_in(cur, override=False)
                    known[name] = node.conf.get_output_type(cur)
                else:
                    known[name] = node.conf.get_output_type(in_types)
        return conf
