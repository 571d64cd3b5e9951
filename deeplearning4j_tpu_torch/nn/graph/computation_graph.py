"""ComputationGraph: the DAG network (counterpart of
nn/graph/computation_graph.py).

The forward walks the configuration's topological order eagerly; the
parameters, layer state and updater state are lists in the order of the
layer nodes in that order, so the flat views match the JAX package's.
Training is the MultiLayerNetwork machinery (`NetworkBase`): the loss
(every output layer's score in the storage dtype, plus regularization and
auxiliary losses), `value_and_grad`, gradient normalization, the updaters
and, in `fit_on_device`, the divergence sentinel.

The fused route: in training, every 1x1 ConvolutionLayer ->
BatchNormalization pair that `_conv_bn_fusable` accepts runs as one
`ops.conv_fused.conv1x1_bn_act` call (K10 on the card, its plain version
on the CPU), on every device; the JAX package takes that route only with
its helpers on (DL4J_TPU_HELPERS=1), so the port's numbers are the JAX
package's with helpers on. Inference normalizes with the running
statistics and never fuses.

Not ported, and raising NotImplementedError: `set_gradients_accumulator`
(K11), `configure_health`, truncated BPTT (`fit_tbptt`, `fit_batch`'s
`rnn_init_states`, a TruncatedBPTT configuration), `rnn_time_step` /
`rnn_clear_previous_state`, and `evaluate` (eval/ is not ported).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.enums import Activation, BackpropType
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.device import DeviceLike
from deeplearning4j_tpu_torch.nn.conf.graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers.base import apply_dropout
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import \
    ConvolutionLayer
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import EmbeddingLayer
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu_torch.nn.multilayer import (NetworkBase,
                                                    _apply_updates,
                                                    _guarded_update,
                                                    _not_ported,
                                                    value_and_grad)
from deeplearning4j_tpu_torch.ops.conv_fused import conv1x1_bn_act
from deeplearning4j_tpu_torch.util.dtypes import cast_floats
from deeplearning4j_tpu_torch.util.flat_params import flatten_params


def _as_list(x) -> List:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class ComputationGraph(NetworkBase):
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = "cuda"):
        self.layer_names: List[str] = [n for n in conf.topo_order
                                       if conf.nodes[n].kind == "layer"]
        super().__init__(conf, device,
                         [conf.nodes[n].conf for n in self.layer_names])
        self._layer_idx = {n: i for i, n in enumerate(self.layer_names)}
        self._consumed = {i for node in conf.nodes.values()
                          for i in node.inputs}
        self._fusable: Optional[Dict[str, str]] = None

    def _layer_input_types(self):
        in_types = self.conf.node_input_types()
        return [in_types[n][0] for n in self.layer_names]

    # ------------------------------------------------------------- forward
    def _conv_bn_fusable(self) -> Dict[str, str]:
        """{conv node: BN node} for the 1x1 conv -> BatchNorm pairs the
        fused route takes: an exact ConvolutionLayer with a 1x1 kernel, no
        padding or dilation, equal strides, IDENTITY activation, no dropout
        or preprocessor, whose only consumer (and not a graph output) is a
        BatchNormalization with IDENTITY or RELU activation, no dropout or
        preprocessor, and gamma/beta not locked. Computed once."""
        if self._fusable is not None:
            return self._fusable
        nodes = self.conf.nodes
        consumers: Dict[str, List[str]] = {}
        for name, node in nodes.items():
            for src in node.inputs:
                consumers.setdefault(src, []).append(name)
        fusable: Dict[str, str] = {}
        for name, node in nodes.items():
            conv = node.conf
            if node.kind != "layer" or type(conv) is not ConvolutionLayer:
                continue
            if tuple(conv.kernel_size) != (1, 1) \
                    or tuple(conv.dilation) != (1, 1) \
                    or tuple(conv.padding) != (0, 0) \
                    or conv.stride[0] != conv.stride[1] \
                    or conv.activation != Activation.IDENTITY \
                    or conv.dropout > 0 or node.preprocessor is not None:
                continue
            outs = consumers.get(name, [])
            if len(outs) != 1 or name in self.conf.outputs:
                continue
            bn_node = nodes[outs[0]]
            bn = bn_node.conf
            if bn_node.kind != "layer" \
                    or type(bn) is not BatchNormalization \
                    or bn.lock_gamma_beta or bn.dropout > 0 \
                    or bn_node.preprocessor is not None \
                    or bn.activation not in (Activation.IDENTITY,
                                             Activation.RELU):
                continue
            fusable[name] = outs[0]
        self._fusable = fusable
        return fusable

    def _forward_all(self, params_tree, state_tree,
                     inputs: List[torch.Tensor], *, train: bool,
                     generator=None, fmasks=None, labels=None, lmasks=None):
        """Walk the DAG in topological order. Returns (activations by node
        name, new layer states, total loss of the output layers or None).
        With `labels` (one per graph output), each output layer adds its
        score, in the storage dtype on the uncast params, and computes its
        activation only when another node consumes it."""
        cd = self.compute_dtype
        mixed = cd != self.dtype
        params_full = params_tree
        if mixed:
            params_tree = cast_floats(params_tree, cd)
        nodes = self.conf.nodes
        values: Dict[str, torch.Tensor] = dict(zip(self.conf.inputs, inputs))
        masks = dict(zip(self.conf.inputs,
                         fmasks or [None] * len(self.conf.inputs)))
        new_states = list(state_tree)
        label_map, lmask_map, total = {}, {}, None
        if labels is not None:
            label_map = dict(zip(self.conf.outputs, labels))
            lmask_map = dict(zip(self.conf.outputs,
                                 lmasks or [None] * len(labels)))
            total = torch.zeros((), dtype=self.dtype, device=self.device)
        fusable = self._conv_bn_fusable() if train else {}
        pending: Dict[str, tuple] = {}            # conv name -> (x, idx, conf)
        for name in self.conf.topo_order:
            node = nodes[name]
            src = node.inputs[0] if node.inputs else None
            if name in fusable:
                # the conv's sole consumer, a BN node, runs the fused pair
                cur = values[src]
                pending[name] = (cur.to(cd) if mixed else cur,
                                 self._layer_idx[name], node.conf)
                values[name], masks[name] = None, masks.get(src)
                continue
            if node.kind == "layer" and src in pending:
                x0, ci, conv = pending.pop(src)
                i, bn = self._layer_idx[name], node.conf
                cp, bp = params_tree[ci], params_tree[i]
                w = cp["W"][:, :, 0, 0]
                bias = cp.get("b")
                if bias is None:
                    bias = torch.zeros((w.shape[0],), dtype=w.dtype,
                                       device=w.device)
                out, m_b, v_b = conv1x1_bn_act(
                    x0, w, bp["gamma_w"], bp["beta"], bias, bn.eps,
                    bn.activation == Activation.RELU, conv.stride[0])
                # BatchNormalization's running update: the batch statistics
                # cast to the activation dtype before the blend
                d, st = bn.decay, state_tree[i]
                new_states[i] = {
                    "mean": d * st["mean"] + (1 - d) * m_b.to(x0.dtype),
                    "var": d * st["var"] + (1 - d) * v_b.to(x0.dtype)}
                values[name], masks[name] = out, masks.get(src)
                continue
            in_vals = [values[i] for i in node.inputs]
            in_masks = [masks.get(i) for i in node.inputs]
            if node.kind == "vertex":
                values[name], masks[name] = node.conf.forward(in_vals,
                                                              in_masks)
                continue
            layer, i = node.conf, self._layer_idx[name]
            cur, mask = in_vals[0], in_masks[0]
            if mixed and not isinstance(layer, EmbeddingLayer):
                cur = cur.to(cd)
            if node.preprocessor is not None:
                cur = node.preprocessor.preprocess(cur)
                mask = node.preprocessor.feed_forward_mask(mask)
            if train and layer.dropout > 0 and generator is not None:
                cur = apply_dropout(cur, layer.dropout, generator)
            if name in label_map and layer.is_output_layer():
                lm = lmask_map.get(name)
                if lm is None and mask is not None and cur.dim() == 3:
                    lm = mask
                total = total + layer.compute_score(
                    params_full[i], cur.to(self.dtype), label_map[name], lm)
                if name not in self._consumed:
                    continue
            out, ns, m = layer.forward(params_tree[i], state_tree[i], cur,
                                       train=train, mask=mask)
            if name not in label_map:
                new_states[i] = ns
            values[name], masks[name] = out, m
        if mixed:
            new_states = cast_floats(new_states, self.dtype)
        return values, new_states, total

    def _inputs(self, xs) -> List[torch.Tensor]:
        return [self._tensor(v) for v in _as_list(xs)]

    @torch.no_grad()
    def output(self, *inputs, train: bool = False
               ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """The configured outputs for `inputs` (one tensor per graph input,
        or one list of them); a single tensor for a single output."""
        self._check_init()
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        values, _, _ = self._forward_all(self.params_tree, self.state_tree,
                                         self._inputs(inputs), train=train)
        outs = [values[o].to(self.dtype) for o in self.conf.outputs]
        return outs[0] if len(outs) == 1 else outs

    @torch.no_grad()
    def feed_forward(self, *inputs, train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Every node's activation by name."""
        self._check_init()
        values, _, _ = self._forward_all(self.params_tree, self.state_tree,
                                         self._inputs(inputs), train=train)
        return values

    # ------------------------------------------------------------------ loss
    def _loss_fn(self, params_tree, state_tree, x, y, fmask, lmask,
                 generator, train: bool = True):
        """(loss, new_states): the output layers' scores plus
        regularization and auxiliary losses. x, y, fmask, lmask are lists
        (one entry per graph input / output) or None for the masks."""
        _, new_states, loss = self._forward_all(
            params_tree, state_tree, x, train=train, generator=generator, fmasks=fmask,
            labels=y, lmasks=lmask)
        reg = sum((layer.regularization_score(p)
                   for layer, p in zip(self.layers, params_tree)),
                  torch.zeros((), dtype=torch.float32))
        aux = sum((ns["__aux_loss__"].sum() for ns in new_states
                   if isinstance(ns, dict) and "__aux_loss__" in ns),
                  torch.zeros((), dtype=torch.float32))
        return loss + reg + aux, new_states

    def _value_and_grad(self, params_tree, state_tree, x, y, fmask, lmask,
                        generator):
        loss, ns, grads = value_and_grad(
            lambda p: self._loss_fn(p, state_tree, x, y, fmask, lmask,
                                    generator, True), params_tree)
        return loss, ns, grads

    def _batch(self, x, y, fmask, lmask):
        """Inputs, labels and masks as lists of tensors on the device."""
        return (self._inputs(x), self._inputs(y),
                None if fmask is None else self._inputs(fmask),
                None if lmask is None else self._inputs(lmask))

    # -------------------------------------------------------------- training
    def fit_batch(self, x, y, fmask=None, lmask=None, rnn_init_states=None):
        """One optimization step on one minibatch (x, y: one array per
        graph input / output, or a list of them)."""
        self._check_init()
        if rnn_init_states is not None:
            _not_ported("fit_batch with rnn_init_states on a "
                        "ComputationGraph", "the graph's truncated BPTT")
        x, y, fmask, lmask = self._batch(x, y, fmask, lmask)
        loss, ns, grads = self._value_and_grad(
            self.params_tree, self.state_tree, x, y, fmask, lmask,
            self._generator)
        with torch.no_grad():
            self.params_tree, self._opt_state = _apply_updates(
                self.layers, self._updaters, grads, self._opt_state,
                self.params_tree, self._step)
        self.state_tree = ns
        self._step += 1
        self._score = loss
        for lst in self._listeners:
            lst.iteration_done(self, self._step)

    def fit_on_device(self, x, y, steps: Optional[int] = None, fmask=None,
                      lmask=None, sync: bool = True,
                      vary_batch: bool = False):
        """`steps` training steps on one batch with no host sync between
        them (the JAX package's benchmark loop; `vary_batch` rolls the
        batch by the step index). Returns the per-step losses, read back
        once with the divergence check when `sync`, else a device tensor.
        After a non-finite loss params, updater state and layer state stay
        frozen for the rest of the call."""
        self._check_init()
        if steps is None:
            raise ValueError("steps is required (single-batch device loop)")
        x, y, fmask, lmask = self._batch(x, y, fmask, lmask)
        params, opt, states = self.params_tree, self._opt_state, \
            self.state_tree
        div = torch.full((), -1, dtype=torch.int64, device=self.device)
        losses = []
        step_c = self._step

        def roll(ts):
            return None if ts is None else [torch.roll(t, step_c, 0)
                                            for t in ts]
        for _ in range(int(steps)):
            b = (roll(x), roll(y), roll(fmask), roll(lmask)) if vary_batch \
                else (x, y, fmask, lmask)
            loss, ns, grads = self._value_and_grad(params, states, *b,
                                                   self._generator)
            with torch.no_grad():
                params, opt, states, div = _guarded_update(
                    self.layers, self._updaters, grads, opt, params, states,
                    ns, loss, div, step_c)
            losses.append(loss)
            step_c += 1
        self.params_tree, self._opt_state, self.state_tree = params, opt, \
            states
        return self._finish_device_loop(losses, steps, div, sync)

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(x(s), y(s)) | fit(DataSet) | fit(iterable of DataSets[,
        epochs])."""
        self._check_init()
        if labels is not None:
            for _ in range(epochs):
                self.fit_batch(data, labels)
            return self
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self._fit_one(data)
            return self
        for _ in range(epochs):
            for lst in self._listeners:
                if hasattr(lst, "on_epoch_start"):
                    lst.on_epoch_start(self)
            if hasattr(data, "reset"):
                data.reset()
            t0 = time.time()
            for ds in data:
                self._last_etl_ms = (time.time() - t0) * 1e3
                self._fit_one(ds)
                t0 = time.time()
            for lst in self._listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def _fit_one(self, ds: DataSet):
        if self.conf.backprop_type == BackpropType.TruncatedBPTT \
                and np.ndim(_as_list(ds.features)[0]) == 3:
            self.fit_tbptt(ds.features, ds.labels, ds.features_mask,
                           ds.labels_mask)
        else:
            self.fit_batch(ds.features, ds.labels, ds.features_mask,
                           ds.labels_mask)

    # ------------------------------------------------------------- scoring
    def score(self, ds: Optional[DataSet] = None,
              training: bool = False) -> float:
        """The last training step's loss, or the loss on `ds` (no
        dropout)."""
        self._check_init()
        if ds is None:
            return float(self._score)
        x, y, fm, lm = self._batch(ds.features, ds.labels, ds.features_mask,
                                   ds.labels_mask)
        with torch.no_grad():
            loss, _ = self._loss_fn(self.params_tree, self.state_tree, x, y,
                                    fm, lm, None, training)
        return float(loss)

    def gradient_and_score(self, x, y, fmask=None, lmask=None):
        """(flat gradient in the JAX package's order, score); training-mode
        forward (the fused route), no dropout."""
        self._check_init()
        loss, _, grads = self._value_and_grad(
            self.params_tree, self.state_tree,
            *self._batch(x, y, fmask, lmask), None)
        return flatten_params(grads), float(loss)

    @torch.no_grad()
    def score_examples(self, ds: DataSet, add_regularization: bool = False):
        """(batch,) per-example scores of a single-output graph: the output
        layer's loss per example, plus the L1/L2 penalty on every entry
        with `add_regularization`."""
        self._check_init()
        if len(self.conf.outputs) != 1:
            raise NotImplementedError(
                "score_examples supports single-output graphs")
        out_name = self.conf.outputs[0]
        node = self.conf.nodes[out_name]
        fn = getattr(node.conf, "compute_score_per_example", None)
        if fn is None:
            raise NotImplementedError(
                f"{type(node.conf).__name__} has no per-example scoring")
        x, y, fm, lm = self._batch(ds.features, ds.labels, ds.features_mask,
                                   ds.labels_mask)
        values, _, _ = self._forward_all(self.params_tree, self.state_tree,
                                         x, train=False, fmasks=fm)
        cur = values[node.inputs[0]].to(self.dtype)
        if node.preprocessor is not None:
            cur = node.preprocessor.preprocess(cur)
        per = fn(self.params_tree[self._layer_idx[out_name]], cur, y[0],
                 None if lm is None else lm[0])
        if add_regularization:
            per = per + sum((layer.regularization_score(p) for layer, p in
                             zip(self.layers, self.params_tree)),
                            torch.zeros((), dtype=torch.float32))
        return per
    scoreExamples = score_examples

    def clone(self) -> "ComputationGraph":
        other = ComputationGraph(
            ComputationGraphConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        other.init(params=self.params_tree)
        other.set_updater_state_view(self.get_updater_state_view())
        return other

    # ------------------------------------------------------- not ported yet
    def fit_tbptt(self, x, y, fmask=None, lmask=None):
        _not_ported("truncated BPTT on a ComputationGraph (fit_tbptt)",
                    "a later slice of the graph path")

    def rnn_time_step(self, *inputs):
        _not_ported("rnn_time_step on a ComputationGraph",
                    "a later slice of the graph path")
    rnnTimeStep = rnn_time_step

    def rnn_clear_previous_state(self):
        _not_ported("rnn_clear_previous_state on a ComputationGraph",
                    "a later slice of the graph path")

    def evaluate(self, iterator):
        _not_ported("evaluate", "eval/ (Evaluation)")

