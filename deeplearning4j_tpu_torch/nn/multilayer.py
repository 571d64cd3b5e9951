"""MultiLayerNetwork (counterpart of nn/multilayer.py): inference and
training of a sequential layer stack.

Parameters are a list (one entry per layer) of dicts of tensors under the
JAX package's names and layouts (`W` and `w_*` are (n_in, n_out), applied
as `x @ W`); the updater state mirrors it, one nest per layer. The flat
views (`params()`, `gradient_and_score`, the updater-state view) use the
JAX package's leaf order: layers in order, dict keys sorted.

A training step is the JAX package's jitted step written eagerly: the
loss (`_loss_fn`: forward, output-layer score in the storage dtype,
regularization, auxiliary losses), `torch.autograd.grad` over the params,
gradient normalization, the updater, and `params - updates`.
`fit_on_device` runs the JAX package's on-device `lax.scan` as a host loop
that keeps everything on the card: per-step losses stay tensors, the
divergence sentinel is a device scalar, and `sync=True` reads both back
once at the end.

Recurrent state, as in the JAX package: `fit_batch` runs every LSTM layer
from the states in `rnn_init_states` (zeros where None) and returns each
one's final (h, c), None for a bidirectional layer; truncated BPTT
(`fit` on a TruncatedBPTT configuration with 3-D features) splits the
time axis into tbptt_fwd_length segments and carries those states,
detached, from one segment to the next. `fit_batch` and `fit_on_device`
themselves train such a configuration on the whole sequence.
`rnn_time_step` streams inference with the states kept between calls.

Input preprocessors run before their layer, as in the JAX package, and
every layer input is cast to the compute dtype except an EmbeddingLayer's
indices. `NetworkBase` holds what `ComputationGraph` shares with this
class: initialization, the flat views, listeners, the gradient step
(`value_and_grad`) and the guarded `fit_on_device` update.

Not ported, and raising NotImplementedError: `set_gradients_accumulator`
(K11), `configure_health` (telemetry/health.py), `pretrain` /
`pretrain_layer`.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.common.enums import (BackpropType,
                                                   GradientNormalization)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers.base import apply_dropout
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import EmbeddingLayer
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import apply_preprocessor
from deeplearning4j_tpu_torch.nn.divergence import DivergenceSentinelMixin
from deeplearning4j_tpu_torch.nn.updater.updaters import BaseUpdater, NoOp
from deeplearning4j_tpu_torch.util.dtypes import cast_floats
from deeplearning4j_tpu_torch.util.flat_params import (flatten_params,
                                                       num_params, tree_map,
                                                       unflatten_params)


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a JAX/numpy dtype name ("float32", "bfloat16", ...)
    or a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _normalize_gradients(layer, grads: Dict[str, torch.Tensor]):
    """Per-layer gradient normalization (GradientNormalization semantics)."""
    gn = layer.gradient_normalization
    if gn == GradientNormalization.NoNormalization or not grads:
        return grads
    thr = layer.gradient_normalization_threshold
    if gn == GradientNormalization.ClipElementWiseAbsoluteValue:
        return {k: torch.clamp(g, -thr, thr) for k, g in grads.items()}
    if gn in (GradientNormalization.ClipL2PerLayer,
              GradientNormalization.RenormalizeL2PerLayer):
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values())
                          + 1e-12)
        if gn == GradientNormalization.RenormalizeL2PerLayer:
            scale = 1.0 / norm
        else:
            scale = torch.where(norm > thr, thr / norm,
                                torch.ones_like(norm))
        return {k: g * scale for k, g in grads.items()}
    out = {}                                   # per-param-type variants
    for k, g in grads.items():
        norm = torch.sqrt((g * g).sum() + 1e-12)
        if gn == GradientNormalization.RenormalizeL2PerParamType:
            out[k] = g / norm
        else:                                  # ClipL2PerParamType
            out[k] = g * torch.where(norm > thr, thr / norm,
                                     torch.ones_like(norm))
    return out


def _compute_updates(layers, updaters, grads, opt_state, params_tree, step):
    """Per layer: normalize the gradients, run the updater. Returns
    (updates, new_opt_state)."""
    upds, new_opt = [], []
    for layer, u, g, st, p in zip(layers, updaters, grads, opt_state,
                                  params_tree):
        upd, st2 = u.update(_normalize_gradients(layer, g), st, p, step)
        upds.append(upd)
        new_opt.append(st2)
    return upds, new_opt


def _apply_updates(layers, updaters, grads, opt_state, params_tree, step):
    """params' = params - updater(grads) for every layer."""
    upds, new_opt = _compute_updates(layers, updaters, grads, opt_state,
                                     params_tree, step)
    return [tree_map(lambda p, d: p - d, pt, ut)
            for pt, ut in zip(params_tree, upds)], new_opt


def _guarded_update(layers, updaters, grads, opt, params, states,
                    new_states, loss, div, step):
    """One step of a `fit_on_device` loop: (params, opt, states, div)
    after the update, except that params, updater state and layer state
    stay as they were once this step's or an earlier step's loss is
    non-finite (a select per buffer on the device); `div` records the
    first bad step (-1 while clean)."""
    newp, newo = _apply_updates(layers, updaters, grads, opt, params, step)
    finite = torch.isfinite(loss)
    bad = ~finite | (div >= 0)

    def keep(new, old):
        return tree_map(lambda a, b: torch.where(bad, b, a)
                        if isinstance(a, torch.Tensor) else a, new, old)
    div = torch.where((div < 0) & ~finite, torch.full_like(div, step), div)
    return keep(newp, params), keep(newo, opt), keep(new_states, states), div


def value_and_grad(loss_fn, params_tree):
    """(loss, aux, grads) of `loss_fn(params) -> (loss, aux)`: one forward
    and backward, the grads in the params' structure (zeros where the loss
    does not depend on a param), loss and aux detached."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in params_tree]
    flat = [(i, k) for i, p in enumerate(leaves) for k in p]
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        gs = torch.autograd.grad(loss, [leaves[i][k] for i, k in flat],
                                 allow_unused=True) if flat else []
    grads = [{} for _ in leaves]
    for (i, k), g in zip(flat, gs):
        grads[i][k] = torch.zeros_like(leaves[i][k]) if g is None else g
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor)
                   else a, aux)
    return loss.detach(), aux, grads


def _not_ported(what: str, waits_for: str):
    raise NotImplementedError(f"{what} is not ported to deeplearning4j_tpu_"
                              f"torch yet: it waits for {waits_for} "
                              "(ROADMAP.md)")


class NetworkBase(DivergenceSentinelMixin):
    """What MultiLayerNetwork and ComputationGraph share. A subclass sets
    `conf`, `device`, `layers` (in flat-view order) and implements
    `_layer_input_types()`."""

    def __init__(self, conf, device: DeviceLike, layers):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers = layers
        self.params_tree: List[Dict[str, torch.Tensor]] = []
        self.state_tree: List[Dict[str, Any]] = []
        self._updaters: List[BaseUpdater] = []
        self._opt_state: List[Any] = []
        self._step = 0
        self._score: Any = float("nan")
        self._listeners: List[Any] = []
        self._generator: Optional[torch.Generator] = None
        self._initialized = False
        self._last_etl_ms = 0.0
        gc = conf.global_conf
        self.dtype = torch_dtype(gc.dtype)
        self.compute_dtype = torch_dtype(gc.compute_dtype) \
            if gc.compute_dtype else self.dtype

    def _layer_input_types(self):
        raise NotImplementedError

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Sequence[Dict[str, Any]]] = None,
             generator: Optional[torch.Generator] = None):
        """Initialize parameters and updater state: copies of `params`
        (tensors or arrays, one dict per layer) when given, else fresh draws
        from `generator` (default: a CPU generator seeded with the
        configuration's seed, so the weights do not depend on the device).
        Dropout draws from a generator on the network's device, seeded
        with seed + 1."""
        seed = self.conf.global_conf.seed
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        input_types = self._layer_input_types()
        self.params_tree, self.state_tree = [], []
        for i, layer in enumerate(self.layers):
            if params is not None:
                p = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                        v, torch.Tensor) else v).to(self.device, self.dtype,
                                                    copy=True)
                     for k, v in params[i].items()}
            elif layer.has_params():
                p = layer.init_params(generator, input_types[i], self.dtype,
                                      self.device)
            else:
                p = {}
            self.params_tree.append(p)
            self.state_tree.append(layer.init_state(
                input_types[i], self.dtype, self.device))
        global_updater = self.conf.get_updater()
        self._updaters = []
        for layer in self.layers:
            if layer.frozen:
                self._updaters.append(NoOp())     # frozen: params never step
            elif layer.updater is not None:
                u = layer.updater
                self._updaters.append(BaseUpdater.from_dict(u)
                                      if isinstance(u, dict) else u)
            else:
                self._updaters.append(global_updater)
        self._opt_state = [u.init(p) for u, p in zip(self._updaters,
                                                     self.params_tree)]
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self._step = 0
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("Call net.init() first")

    def _tensor(self, a, dtype=None):
        """`a` (array or tensor; None stays None) on the network's device,
        in `dtype` (default: the storage dtype)."""
        if a is None:
            return None
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self.device, dtype or self.dtype)

    # ----------------------------------------------------------- flat views
    def params(self) -> torch.Tensor:
        """One flat parameter vector, in the JAX package's order."""
        return flatten_params(self.params_tree)

    def set_params(self, flat):
        self.params_tree = unflatten_params(self.params_tree,
                                            self._tensor(flat))

    def num_params(self) -> int:
        return num_params(self.params_tree)

    def get_updater_state_view(self) -> torch.Tensor:
        return flatten_params(self._opt_state)

    def set_updater_state_view(self, flat):
        self._opt_state = unflatten_params(self._opt_state,
                                           self._tensor(flat))

    def _finish_device_loop(self, losses, steps: int, div, sync: bool):
        """Book-keeping after a `fit_on_device` loop of `steps` steps:
        the per-step losses as a device tensor (sync=False) or a numpy
        array read back once with the divergence sentinel (sync=True)."""
        self._step += int(steps)
        losses_t = torch.stack(losses) if losses else torch.zeros(
            (0,), dtype=self.dtype, device=self.device)
        self._stash_pending_div(div)
        if not sync:
            if losses:
                self._score = losses_t[-1]
            return losses_t
        # one readback: the losses and the sentinel together
        both = torch.cat([losses_t.double(),
                          self._pending_div.double()[None]]).cpu().numpy()
        out = both[:-1].astype(np.float64 if losses_t.dtype == torch.float64
                               else np.float32)
        if losses:
            self._score = float(out[-1])
        self._resolve_divergence(int(both[-1]))
        return out

    # ----------------------------------------------------------- listeners
    def set_listeners(self, *listeners):
        self._listeners = list(listeners)
    setListeners = set_listeners

    def get_listeners(self):
        return self._listeners

    @property
    def last_etl_ms(self):
        return self._last_etl_ms

    # ------------------------------------------------------- not ported yet
    def set_gradients_accumulator(self, acc):
        _not_ported("set_gradients_accumulator",
                    "parallel/accumulation.py and its kernel K11")

    def configure_health(self, *args, **kwargs):
        _not_ported("configure_health (the training-health monitor)",
                    "telemetry/health.py")


class MultiLayerNetwork(NetworkBase):
    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = "cuda"):
        super().__init__(conf, device, conf.layers)
        self._rnn_state: Optional[List[Any]] = None

    def _layer_input_types(self):
        return self.conf.input_types_per_layer()

    def init(self, params: Optional[Sequence[Dict[str, Any]]] = None,
             generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        super().init(params, generator)
        self._rnn_state = None
        return self

    def _n_rnn(self) -> int:
        """LSTM layers (bidirectional ones included): the length of a
        recurrent-state list."""
        return sum(1 for layer in self.layers if isinstance(layer, LSTM))

    # ------------------------------------------------------------- forward
    def _forward(self, x, collect: bool, rnn_init_states=None):
        """(output in the storage dtype, activations, final (h, c) per
        LSTM layer). With `rnn_init_states` (one entry per LSTM layer, None
        for zeros) every LSTM layer starts from its state; a bidirectional
        LSTM layer has no streamable state and raises."""
        cd = self.compute_dtype
        params = self.params_tree if cd == self.dtype else cast_floats(
            self.params_tree, cd)
        if rnn_init_states is not None and cd != self.dtype:
            rnn_init_states = cast_floats(rnn_init_states, cd)
        cur = x
        acts = [x]
        mask = None
        final_rnn = []
        for i, layer in enumerate(self.layers):
            if not isinstance(layer, EmbeddingLayer):
                cur = cur.to(cd)
            if i in self.conf.preprocessors:
                cur, mask = apply_preprocessor(self.conf.preprocessors[i],
                                               cur, mask, x.shape[0])
            if isinstance(layer, LSTM) and rnn_init_states is not None:
                if isinstance(layer, GravesBidirectionalLSTM):
                    raise ValueError(
                        f"layer {i} ({type(layer).__name__}) is "
                        "bidirectional: it has no state to carry from one "
                        "call to the next, so it cannot stream")
                init = rnn_init_states[len(final_rnn)]
                cur, hc = layer._scan(params[i], cur, mask,
                                      *(init if init is not None else ()))
                final_rnn.append(hc)
            else:
                if isinstance(layer, LSTM):
                    final_rnn.append(None)
                cur, _, mask = layer.forward(params[i], self.state_tree[i],
                                             cur, train=False, mask=mask)
            if collect:
                acts.append(cur)
        return cur.to(self.dtype), acts, final_rnn

    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Inference forward pass over the whole stack."""
        self._check_init()
        return self._forward(self._tensor(x), collect=False)[0]

    @torch.no_grad()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations, input first."""
        self._check_init()
        return self._forward(self._tensor(x), collect=True)[1]

    # ------------------------------------------------------------------ loss
    def _loss_fn(self, params_tree, x, y, fmask, lmask, generator,
                 train: bool = True, per_example: bool = False,
                 rnn_init_states=None):
        """(loss, new_states, final_rnn). Mixed precision as in the JAX
        package: the params, every layer input and the carried recurrent
        states are cast to `compute_dtype`, the output layer and its loss
        run in the storage dtype on the uncast params, and so does the
        regularization. Dropout draws from `generator` only when training
        with a generator. With `rnn_init_states` (one entry per LSTM
        layer) every non-bidirectional LSTM layer runs from its state
        (zeros where None) and final_rnn holds its final (h, c), in the
        compute dtype; bidirectional LSTM layers hold None."""
        out_layer = self.layers[-1]
        if not out_layer.is_output_layer():
            raise ValueError("Last layer must be an output/loss layer for "
                             "scoring")
        cd = self.compute_dtype
        mixed = cd != self.dtype
        params_full = params_tree
        if mixed:
            params_tree = cast_floats(params_tree, cd)
            if rnn_init_states is not None:
                rnn_init_states = cast_floats(rnn_init_states, cd)
        mask, cur = fmask, x
        new_states, final_rnn = [], []
        pps = self.conf.preprocessors
        for i, layer in enumerate(self.layers[:-1]):
            if mixed and not isinstance(layer, EmbeddingLayer):
                cur = cur.to(cd)
            if i in pps:
                cur, mask = apply_preprocessor(pps[i], cur, mask, x.shape[0])
            if train and layer.dropout > 0 and generator is not None:
                cur = apply_dropout(cur, layer.dropout, generator)
            if isinstance(layer, LSTM) and rnn_init_states is not None:
                if isinstance(layer, GravesBidirectionalLSTM):
                    final_rnn.append(None)     # no streamable state
                else:
                    init = rnn_init_states[len(final_rnn)]
                    cur, hc = layer._scan(params_tree[i], cur, mask,
                                          *(init if init is not None
                                            else ()))
                    final_rnn.append(hc)
                    new_states.append(self.state_tree[i])
                    continue

            def fwd(p, s, c, m, _layer=layer):
                return _layer.forward(p, s, c, train=train, mask=m)

            if self.conf.global_conf.remat and torch.is_grad_enabled():
                # gradient checkpointing: this layer's activations are
                # recomputed in the backward pass (memory for FLOPs)
                cur, ns, mask = checkpoint(fwd, params_tree[i],
                                           self.state_tree[i], cur, mask,
                                           use_reentrant=False)
            else:
                cur, ns, mask = fwd(params_tree[i], self.state_tree[i], cur,
                                    mask)
            new_states.append(ns)
        li = len(self.layers) - 1
        if li in pps:
            cur, mask = apply_preprocessor(pps[li], cur, mask, x.shape[0])
        if train and out_layer.dropout > 0 and generator is not None:
            cur = apply_dropout(cur, out_layer.dropout, generator)
        score_mask = lmask if lmask is not None else (
            mask if getattr(out_layer, "loss_fn", None) is not None
            and cur.ndim == 3 else None)
        if mixed:
            cur = cur.to(self.dtype)
            new_states = cast_floats(new_states, self.dtype)
        if per_example:
            return out_layer.compute_score_per_example(
                params_full[-1], cur, y, score_mask), new_states, final_rnn
        loss = out_layer.compute_score(params_full[-1], cur, y, score_mask)
        new_states.append(self.state_tree[-1])
        reg = sum((layer.regularization_score(p)
                   for layer, p in zip(self.layers, params_full)),
                  torch.zeros((), dtype=torch.float32))
        # auxiliary-loss seam: a layer may publish a data-dependent loss
        # term in its new state under "__aux_loss__"
        aux = sum((ns["__aux_loss__"].sum() for ns in new_states
                   if isinstance(ns, dict) and "__aux_loss__" in ns),
                  torch.zeros((), dtype=torch.float32))
        return loss + reg + aux, new_states, final_rnn

    def _value_and_grad(self, params_tree, x, y, fmask, lmask, generator,
                        rnn_init_states=None):
        """(loss, new_states, grads, final_rnn): one forward and backward,
        the grads in the params' structure (zeros where the loss does not
        depend on a param), the final recurrent states detached."""
        def fn(p):
            loss, ns, final_rnn = self._loss_fn(
                p, x, y, fmask, lmask, generator, True,
                rnn_init_states=rnn_init_states)
            return loss, (ns, final_rnn)
        loss, (ns, final_rnn), grads = value_and_grad(fn, params_tree)
        return loss, ns, grads, final_rnn

    # -------------------------------------------------------------- training
    def fit_batch(self, x, y, fmask=None, lmask=None, rnn_init_states=None):
        """One optimization step on one minibatch, every LSTM layer
        starting from its entry of `rnn_init_states` (zeros where None or
        when the list is None). Returns the final (h, c) of each LSTM layer
        (None for a bidirectional one), detached, in the compute dtype."""
        self._check_init()
        x, y = self._tensor(x), self._tensor(y)
        fmask, lmask = self._tensor(fmask), self._tensor(lmask)
        if rnn_init_states is None:
            rnn_init_states = [None] * self._n_rnn()
        loss, ns, grads, final_rnn = self._value_and_grad(
            self.params_tree, x, y, fmask, lmask, self._generator,
            rnn_init_states)
        with torch.no_grad():
            self.params_tree, self._opt_state = _apply_updates(
                self.layers, self._updaters, grads, self._opt_state,
                self.params_tree, self._step)
        self.state_tree = ns
        self._step += 1
        self._score = loss          # device scalar; read back by score()
        for lst in self._listeners:
            lst.iteration_done(self, self._step)
        return final_rnn

    def fit_on_device(self, x, y, steps: Optional[int] = None, fmask=None,
                      lmask=None, sync: bool = True,
                      vary_batch: bool = False):
        """Many training steps with no host sync between them. If x/y
        carry a leading step axis (steps, batch, ...) and `steps` is None,
        each step takes its own minibatch; otherwise the same batch is
        used `steps` times. Returns the per-step losses: with `sync=True` a
        numpy array read back once at the end, with the divergence check
        resolved; with `sync=False` a device tensor, the divergence check
        resolving on the next `_diverged_at` access.

        After a non-finite loss, params, updater state and layer state stay
        frozen for the rest of the call and the first bad step is recorded
        (a select per buffer on the device). `vary_batch=True` (same-batch
        mode only) rolls the batch by the step index each step, as the JAX
        package does to keep steps from being loop-invariant."""
        self._check_init()
        per_step_data = steps is None
        if vary_batch and per_step_data:
            raise ValueError("vary_batch applies to the same-batch "
                             "benchmark mode only (steps=int)")
        x, y = self._tensor(x), self._tensor(y)
        fmask, lmask = self._tensor(fmask), self._tensor(lmask)
        if per_step_data:
            steps = x.shape[0]
        params, opt, states = self.params_tree, self._opt_state, \
            self.state_tree
        div = torch.full((), -1, dtype=torch.int64, device=self.device)
        losses = []
        step_c = self._step
        for n in range(int(steps)):
            if per_step_data:
                bx, by = x[n], y[n]
                bfm = None if fmask is None else fmask[n]
                blm = None if lmask is None else lmask[n]
            elif vary_batch:
                def roll(a):
                    return None if a is None else torch.roll(a, step_c, 0)
                bx, by, bfm, blm = roll(x), roll(y), roll(fmask), roll(lmask)
            else:
                bx, by, bfm, blm = x, y, fmask, lmask
            self.state_tree = states       # the layers read the carried state
            loss, ns, grads, _ = self._value_and_grad(
                params, bx, by, bfm, blm, self._generator)
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
        """fit(x, y) | fit(DataSet) | fit(iterable of DataSets[, epochs])."""
        self._check_init()
        if labels is not None:
            for _ in range(epochs):
                self._fit_one(DataSet(data, labels))
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
            if self.conf.backprop_type == BackpropType.TruncatedBPTT:
                # the segment loop carries state on the host: per batch
                t0 = time.time()
                for ds in data:
                    self._last_etl_ms = (time.time() - t0) * 1e3
                    self._fit_one(ds)
                    t0 = time.time()
            else:
                self._fit_epoch_grouped(data)
            for lst in self._listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def _fit_one(self, ds: DataSet):
        if self.conf.backprop_type == BackpropType.TruncatedBPTT \
                and np.ndim(ds.features) == 3:
            self._fit_tbptt(ds)
        else:
            self.fit_batch(ds.features, ds.labels, ds.features_mask,
                           ds.labels_mask)

    def _fit_tbptt(self, ds: DataSet):
        """Truncated BPTT: split the time axis into tbptt_fwd_length
        segments, one optimization step each, the LSTM states carried
        (detached) from one segment to the next."""
        T = ds.features.shape[2]
        L = self.conf.tbptt_fwd_length
        carry = [None] * self._n_rnn()
        for start in range(0, T, L):
            end = min(start + L, T)

            def seg(a, time_axis):
                return None if a is None else (
                    a[..., start:end] if np.ndim(a) == time_axis + 1
                    else a)
            carry = self.fit_batch(seg(ds.features, 2), seg(ds.labels, 2),
                                   seg(ds.features_mask, 1),
                                   seg(ds.labels_mask, 1),
                                   rnn_init_states=carry)

    def _fit_epoch_grouped(self, it):
        """Consecutive same-shape minibatches run as one `fit_on_device`
        call in its per-step mode (at most ~256 MB of stacked features, at
        most 512 steps); listeners see each step's score afterwards."""
        t0 = time.time()
        group: List[DataSet] = []
        max_group = None

        def stack(name):
            if getattr(group[0], name) is None:
                return None
            return torch.stack([self._tensor(getattr(d, name))
                                for d in group])

        def flush():
            nonlocal t0
            if not group:
                return
            self._last_etl_ms = (time.time() - t0) * 1e3
            if len(group) == 1:
                self._fit_one(group[0])
            else:
                losses = self.fit_on_device(
                    stack("features"), stack("labels"),
                    fmask=stack("features_mask"), lmask=stack("labels_mask"))
                base = self._step - len(losses)
                for i, loss in enumerate(losses):
                    self._score = float(loss)
                    for lst in self._listeners:
                        lst.iteration_done(self, base + i + 1)
            group.clear()
            t0 = time.time()

        def signature(ds):
            return tuple(None if a is None else tuple(np.shape(a)) for a in
                         (ds.features, ds.labels, ds.features_mask,
                          ds.labels_mask))

        sig = None
        for ds in it:
            s = signature(ds)
            if sig is not None and s != sig:
                flush()
            sig = s
            if max_group is None:
                nbytes = 8 * (math.prod(np.shape(ds.features))
                              + math.prod(np.shape(ds.labels)))
                max_group = int(max(1, min(512, (256 << 20)
                                           // max(1, nbytes))))
            group.append(ds)
            if len(group) >= max_group:
                flush()
        flush()

    # ------------------------------------------------------------- scoring
    def score(self, ds: Optional[DataSet] = None,
              training: bool = False) -> float:
        """The last training step's loss, or the loss on `ds` (no
        dropout)."""
        self._check_init()
        if ds is None:
            return float(self._score)
        with torch.no_grad():
            loss, _, _ = self._loss_fn(
                self.params_tree, self._tensor(ds.features),
                self._tensor(ds.labels), self._tensor(ds.features_mask),
                self._tensor(ds.labels_mask), None, training)
        return float(loss)

    def score_examples(self, ds: DataSet, add_regularization: bool = False):
        """(batch,) per-example scores: each example's loss summed over its
        outputs (and unmasked timesteps for RNN heads), plus the network's
        L1/L2 penalty on every entry with `add_regularization`."""
        self._check_init()
        with torch.no_grad():
            per, _, _ = self._loss_fn(
                self.params_tree, self._tensor(ds.features),
                self._tensor(ds.labels), self._tensor(ds.features_mask),
                self._tensor(ds.labels_mask), None, False, per_example=True)
            if add_regularization:
                per = per + sum(
                    (layer.regularization_score(p) for layer, p in
                     zip(self.layers, self.params_tree)),
                    torch.zeros((), dtype=torch.float32))
        return per
    scoreExamples = score_examples

    def gradient_and_score(self, x, y, fmask=None, lmask=None):
        """(flat gradient in the JAX package's order, score); no dropout."""
        self._check_init()
        loss, _, grads, _ = self._value_and_grad(
            self.params_tree, self._tensor(x), self._tensor(y),
            self._tensor(fmask), self._tensor(lmask), None)
        return flatten_params(grads), float(loss)

    def clone(self) -> "MultiLayerNetwork":
        other = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        other.init(params=self.params_tree)
        other.set_updater_state_view(self.get_updater_state_view())
        return other

    # ------------------------------------------------------------- rnn API
    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Streaming inference: the stack's output for x (batch, size,
        time), or (batch, size) for one step, every LSTM layer starting
        from the state the previous call left (zeros after `init` or
        `rnn_clear_previous_state`)."""
        self._check_init()
        x = self._tensor(x)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, :, None]
        if self._rnn_state is None:
            self._rnn_state = [None] * self._n_rnn()
        out, _, self._rnn_state = self._forward(
            x, False, rnn_init_states=self._rnn_state)
        return out[:, :, 0] if squeeze else out

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    # ------------------------------------------------------- not ported yet
    def pretrain(self, data, epochs: int = 1):
        _not_ported("pretrain", "the pretrainable layers (AutoEncoder, "
                    "VAE, RBM)")

    def pretrain_layer(self, layer_idx: int, data, epochs: int = 1):
        _not_ported("pretrain_layer", "the pretrainable layers "
                    "(AutoEncoder, VAE, RBM)")
