"""ParallelWrapper: data-parallel training over a mesh of replicas in one
process (counterpart of parallel/parallel_wrapper.py).

The JAX package runs one `shard_map` step over a `Mesh("data")` whose
collectives ride the chips' interconnect. Here every replica is a list of
(params, updater state, layer state, residual) trees on its mesh entry,
stepped in turn on the host; each collective is an explicit sum in replica
order, replica 0 first, so that repeated runs are bitwise equal. Each
replica takes its contiguous shard of the batch.

- SHARED_GRADIENTS (the default): each replica applies its own updater to
  its gradients, encodes every parameter tensor's update with its own
  residual (`threshold_encode_list` over the leaves in tree order: one K11
  launch per replica per step on the card), the messages are summed
  across replicas, and every
  replica subtracts the sum from its params. The float leaves of the layer
  state (BatchNormalization's running statistics) are averaged.
- AVERAGING: the replicas step independently; every `averaging_frequency`
  steps params, updater state and the float leaves of the layer state are
  averaged. A partial last window is averaged when the state is written
  back into the wrapped network.
- CUSTOM: each replica's flat gradient is stored with the caller's
  GradientsAccumulator (`store_update(flat, party=r)`); the aggregate steps
  the updater once on replica 0, and every replica takes the result. The
  float leaves of the layer state are averaged.

The wrapped network (a MultiLayerNetwork or a ComputationGraph) receives
replica 0's params, updater state, layer state and step after every `fit`
and `fit_on_device`. Replica r draws dropout from its own generator on its
device, seeded with the configuration's seed + 1 + r (the JAX package
folds the replica index into a `jax.random` key), so the two packages
agree only for networks without dropout.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (_apply_updates,
                                                    _compute_updates)
from deeplearning4j_tpu_torch.parallel.accumulation import (
    sum_in_order, threshold_encode_list)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, make_mesh
from deeplearning4j_tpu_torch.util.flat_params import (flatten_params,
                                                       tree_leaves, tree_map,
                                                       tree_unflatten,
                                                       unflatten_params)


class TrainingMode:
    AVERAGING = "averaging"
    SHARED_GRADIENTS = "shared_gradients"
    CUSTOM = "custom"


def _to(tree, device):
    """`tree` with every tensor on `device` (no copy where it is there)."""
    return tree_map(lambda a: a.to(device)
                    if isinstance(a, torch.Tensor) else a, tree)


def _is_float(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


class ParallelWrapper:
    def __init__(self, model, workers: Optional[int] = None,
                 prefetch_buffer: int = 2, averaging_frequency: int = 1,
                 training_mode: str = TrainingMode.SHARED_GRADIENTS,
                 gradients_threshold: float = 1e-3,
                 report_score_after_averaging: bool = True,
                 mesh: Optional[Mesh] = None, accumulator=None):
        """`mesh` defaults to `make_mesh(workers)` on the model's device
        type: the first `workers` cards (all of them for None), or
        `workers` replicas (one for None) on the CPU."""
        if training_mode not in (TrainingMode.AVERAGING,
                                 TrainingMode.SHARED_GRADIENTS,
                                 TrainingMode.CUSTOM):
            raise ValueError(f"Unknown training mode: {training_mode!r}")
        if training_mode == TrainingMode.CUSTOM and accumulator is None:
            raise ValueError("TrainingMode.CUSTOM requires a "
                             "GradientsAccumulator")
        self.model = model
        self.mesh = mesh or make_mesh(workers, device=model.device.type)
        self.workers = self.mesh.size
        self.prefetch_buffer = prefetch_buffer
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.training_mode = training_mode
        self.gradients_threshold = float(gradients_threshold)
        self.report_score_after_averaging = report_score_after_averaging
        self.accumulator = accumulator
        self._params: Optional[List[Any]] = None   # per replica, and below
        self._opt: List[Any] = []
        self._states: List[Any] = []
        self._residual: Optional[List[Any]] = None
        self._generators: List[torch.Generator] = []
        self._host_step = 0
        self._score: Any = float("nan")
        self._listeners: List[Any] = []

    # ---------------------------------------------------------------- setup
    def _ensure_setup(self):
        if self._params is not None:
            return
        net = self.model
        net._check_init()
        devs = self.mesh.devices

        def copy(tree, d):
            return tree_map(lambda a: a.to(d, copy=True)
                            if isinstance(a, torch.Tensor) else a, tree)
        self._params = [copy(net.params_tree, d) for d in devs]
        self._opt = [copy(net._opt_state, d) for d in devs]
        self._states = [copy(net.state_tree, d) for d in devs]
        # residuals per parameter tensor: a flat view would cost a
        # concatenation and a re-slice of every parameter a step
        self._residual = [tree_map(torch.zeros_like, p)
                          for p in self._params] \
            if self.training_mode == TrainingMode.SHARED_GRADIENTS else None
        seed = net.conf.global_conf.seed
        self._generators = [
            torch.Generator(device=d).manual_seed(seed + 1 + r)
            for r, d in enumerate(devs)]
        self._host_step = net._step

    # ------------------------------------------------------ one replica's work
    def _prepare(self, x, y, fmask, lmask):
        """The batch on the network's device: tensors for a
        MultiLayerNetwork, lists of them (one per input / output) for a
        ComputationGraph."""
        net = self.model
        if isinstance(net, ComputationGraph):
            return net._batch(x, y, fmask, lmask)
        return (net._tensor(x), net._tensor(y), net._tensor(fmask),
                net._tensor(lmask))

    def _shard(self, a, r: int):
        """Replica r's contiguous rows of `a` (a tensor, a list of them, or
        None), on its device."""
        if a is None:
            return None
        if isinstance(a, list):
            return [self._shard(t, r) for t in a]
        b = a.shape[0] // self.workers
        return a[r * b:(r + 1) * b].to(self.mesh.devices[r])

    def _replica_grads(self, r: int, batch):
        """(loss, new layer state, grads) of replica r on its shard."""
        net = self.model
        x, y, fm, lm = (self._shard(a, r) for a in batch)
        gen = self._generators[r]
        if isinstance(net, ComputationGraph):
            return net._value_and_grad(self._params[r], self._states[r], x, y,
                                       fm, lm, gen)
        loss, ns, grads, _ = net._value_and_grad(
            self._params[r], x, y, fm, lm, gen, state_tree=self._states[r])
        return loss, ns, grads

    def _mean(self, trees):
        """The replica mean of the float leaves of `trees` (one tree per
        replica), on each replica's device; other leaves stay
        replica-local. One replica: as it is."""
        if self.workers == 1:
            return trees

        def mean(*xs):
            return sum_in_order(xs) / len(xs) if _is_float(xs[0]) else xs[0]
        avg = tree_map(mean, trees[0], *trees[1:])
        return [tree_map(lambda a, own: a.to(d) if _is_float(own) else own,
                         avg, t)
                for t, d in zip(trees, self.mesh.devices)]

    # ---------------------------------------------------------------- steps
    def _train_step(self, batch):
        """One step of the mode over all replicas; returns the mean loss."""
        n = (batch[0][0] if isinstance(batch[0], list) else batch[0]).shape[0]
        if n % self.workers != 0:
            raise ValueError(f"Batch size {n} not divisible by workers "
                             f"{self.workers}")
        net = self.model
        layers, updaters = net.layers, net._updaters
        step = self._host_step
        R = self.workers
        losses, states = [], []
        sync = True             # the layer state averaged after this step
        if self.training_mode == TrainingMode.CUSTOM:
            flats = []
            for r in range(R):
                loss, ns, grads = self._replica_grads(r, batch)
                losses.append(loss)
                states.append(ns)
                flats.append(flatten_params(grads))
            with torch.no_grad():
                for r in range(R):
                    self.accumulator.store_update(flats[r], party=r)
                agg = self.accumulator.get_update()
                p0, o0 = self._params[0], self._opt[0]
                grads = unflatten_params(p0, agg.to(self.mesh.devices[0]))
                p0, o0 = _apply_updates(layers, updaters, grads, o0, p0, step)
                self._params = [_to(p0, d) for d in self.mesh.devices]
                self._opt = [_to(o0, d) for d in self.mesh.devices]
        elif self.training_mode == TrainingMode.SHARED_GRADIENTS:
            thr = self.gradients_threshold
            msgs = []
            for r in range(R):
                loss, ns, grads = self._replica_grads(r, batch)
                losses.append(loss)
                states.append(ns)
                with torch.no_grad():
                    upds, self._opt[r] = _compute_updates(
                        layers, updaters, grads, self._opt[r],
                        self._params[r], step)
                    msg, res = threshold_encode_list(
                        tree_leaves(upds), tree_leaves(self._residual[r]),
                        thr)
                    msgs.append(tree_unflatten(upds, msg))
                    self._residual[r] = tree_unflatten(upds, res)
            with torch.no_grad():
                agg = tree_map(lambda *ms: sum_in_order(ms), msgs[0],
                               *msgs[1:])
                self._params = [tree_map(lambda p, a: p - a.to(p.device),
                                         p, agg) for p in self._params]
        else:                                                  # AVERAGING
            for r in range(R):
                loss, ns, grads = self._replica_grads(r, batch)
                losses.append(loss)
                states.append(ns)
                with torch.no_grad():
                    self._params[r], self._opt[r] = _apply_updates(
                        layers, updaters, grads, self._opt[r],
                        self._params[r], step)
            sync = (step + 1) % self.averaging_frequency == 0
            if sync:
                with torch.no_grad():
                    self._params = self._mean(self._params)
                    self._opt = self._mean(self._opt)
        with torch.no_grad():
            self._states = self._mean(states) if sync else states
        self._host_step += 1
        return sum_in_order(losses) / R

    # ---------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1):
        """fit(x, y) | fit(DataSet or MultiDataSet) | fit(iterable of them[,
        epochs]); an iterable runs behind an AsyncDataSetIterator of
        `prefetch_buffer` batches unless it is one already."""
        self._ensure_setup()
        if labels is not None:
            self._fit_one(DataSet(data, labels))
        elif isinstance(data, (DataSet, MultiDataSet)):
            self._fit_one(data)
        else:
            from deeplearning4j_tpu_torch.datasets.iterators import \
                AsyncDataSetIterator
            for _ in range(epochs):
                if hasattr(data, "reset"):
                    data.reset()
                it = data
                if getattr(it, "async_supported", True):
                    it = AsyncDataSetIterator(it,
                                              queue_size=self.prefetch_buffer)
                for ds in it:
                    self._fit_one(ds)
        self._write_back()
        return self

    def _fit_one(self, ds):
        if isinstance(ds, MultiDataSet):
            batch = self._prepare(ds.features, ds.labels, ds.features_masks,
                                  ds.labels_masks)
        else:
            batch = self._prepare(ds.features, ds.labels, ds.features_mask,
                                  ds.labels_mask)
        self._score = self._train_step(batch)
        for lst in self._listeners:
            lst.iteration_done(self, self._host_step)

    def fit_on_device(self, x, y, steps: int, sync: bool = True):
        """`steps` data-parallel steps on the same batch with no host sync
        between them (the JAX package's benchmark loop). Returns the
        per-step mean losses: a numpy array read back once at the end, or
        with `sync=False` a device tensor. Not available in CUSTOM mode,
        whose accumulator runs on the host between steps."""
        if self.training_mode == TrainingMode.CUSTOM:
            raise ValueError(
                "fit_on_device is unsupported in CUSTOM mode: the caller-"
                "provided GradientsAccumulator is applied between steps")
        self._ensure_setup()
        batch = self._prepare(x, y, None, None)
        losses = torch.stack([self._train_step(batch)
                              for _ in range(int(steps))])
        if not sync:
            self._score = losses[-1]
            self._write_back()
            return losses
        out = losses.cpu().numpy()
        self._score = float(out[-1])
        self._write_back()
        return out

    def _average_partial_window(self):
        """AVERAGING: when `averaging_frequency` does not divide the step
        count, the replicas hold un-averaged tail steps; they are averaged
        before the write-back (the reference averages once more after its
        fit loop)."""
        if self.training_mode != TrainingMode.AVERAGING \
                or self.averaging_frequency <= 1 \
                or self._host_step % self.averaging_frequency == 0:
            return
        with torch.no_grad():
            self._params = self._mean(self._params)
            self._opt = self._mean(self._opt)
            self._states = self._mean(self._states)

    def _write_back(self):
        """Replica 0's params, updater state, layer state and step into the
        wrapped network."""
        net = self.model
        self._average_partial_window()
        net.params_tree = _to(self._params[0], net.device)
        net._opt_state = _to(self._opt[0], net.device)
        net.state_tree = _to(self._states[0], net.device)
        net._step = self._host_step

    def score(self):
        return float(self._score)

    def set_listeners(self, *listeners):
        self._listeners = list(listeners)

    def shutdown(self):
        self._params = None
        self._opt, self._states, self._residual = [], [], None

    # ---------------------------------------------------------------- builder
    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n: int):
            self._kw["workers"] = int(n)
            return self

        def prefetch_buffer(self, n: int):
            self._kw["prefetch_buffer"] = int(n)
            return self
        prefetchBuffer = prefetch_buffer

        def averaging_frequency(self, n: int):
            self._kw["averaging_frequency"] = int(n)
            return self
        averagingFrequency = averaging_frequency

        def training_mode(self, m: str):
            self._kw["training_mode"] = m
            return self
        trainingMode = training_mode

        def gradients_threshold(self, t: float):
            self._kw["gradients_threshold"] = float(t)
            return self

        def report_score_after_averaging(self, b: bool):
            self._kw["report_score_after_averaging"] = bool(b)
            return self
        reportScoreAfterAveraging = report_score_after_averaging

        def workspace_mode(self, m):  # accepted for parity; nothing to set
            return self

        def mesh(self, m: Mesh):
            self._kw["mesh"] = m
            return self

        def gradients_accumulator(self, acc):
            """The GradientsAccumulator of TrainingMode.CUSTOM."""
            self._kw["accumulator"] = acc
            return self
        gradientsAccumulator = gradients_accumulator

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._model, **self._kw)
