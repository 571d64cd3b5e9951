"""Dataset iterators and the prefetch thread (counterpart of
datasets/iterators.py).

Iterators are plain Python iterables of `DataSet`s with `reset()`. They
live on the host: `AsyncDataSetIterator` runs the underlying iterator in a
background thread ahead of the training loop, and the network moves each
batch to its device when it takes it (the JAX package's iterator also
stages the batch on its default device; the port's entry points place
data themselves).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Base: an iterable over DataSets with reset()."""
    async_supported = True

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    def batch(self) -> int:
        return -1

    def total_outcomes(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1


class ListDataSetIterator(DataSetIterator):
    """A list of DataSets; one DataSet with `batch` is cut into
    minibatches."""

    def __init__(self, datasets: List[DataSet], batch: Optional[int] = None):
        if batch is not None and len(datasets) == 1:
            datasets = datasets[0].batch_by(batch)
        self._list = list(datasets)
        self._batch = batch or (self._list[0].num_examples() if self._list
                                else -1)

    def __iter__(self):
        return iter(self._list)

    def batch(self):
        return self._batch

    def __len__(self):
        return len(self._list)


class INDArrayDataSetIterator(DataSetIterator):
    """(features, labels) arrays in minibatches of `batch_size`."""

    def __init__(self, features, labels, batch_size: int):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch_size = int(batch_size)

    def __iter__(self):
        n = self.features.shape[0]
        for i in range(0, n, self.batch_size):
            yield DataSet(self.features[i:i + self.batch_size],
                          self.labels[i:i + self.batch_size])

    def batch(self):
        return self.batch_size


class ExistingDataSetIterator(DataSetIterator):
    """Any iterable of DataSets."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._iterable = iterable

    def __iter__(self):
        return iter(self._iterable)


class EarlyTerminationDataSetIterator(DataSetIterator):
    """At most `max_batches` minibatches of the underlying iterator."""

    def __init__(self, underlying: DataSetIterator, max_batches: int):
        self.underlying = underlying
        self.max_batches = int(max_batches)

    def __iter__(self):
        for i, ds in enumerate(self.underlying):
            if i >= self.max_batches:
                break
            yield ds

    def reset(self):
        self.underlying.reset()


class MultipleEpochsIterator(DataSetIterator):
    """The underlying iterator `epochs` times, reset before each."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self.epochs = int(epochs)
        self.underlying = underlying

    def __iter__(self):
        for _ in range(self.epochs):
            self.underlying.reset()
            yield from self.underlying

    def reset(self):
        self.underlying.reset()


class SamplingDataSetIterator(DataSetIterator):
    """Minibatches drawn with replacement from `base`, `total_samples` in
    all; numpy's RandomState(seed + epoch) draws the rows, as in the JAX
    package."""

    def __init__(self, base: DataSet, batch_size: int, total_samples: int,
                 seed: int = 123):
        self.base = base
        self.batch_size = int(batch_size)
        self.total_samples = int(total_samples)
        self.seed = seed
        self._epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        n = self.base.num_examples()
        emitted = 0
        while emitted < self.total_samples:
            take = min(self.batch_size, self.total_samples - emitted)
            idx = rng.randint(0, n, size=take)
            yield DataSet(np.asarray(self.base.features)[idx],
                          np.asarray(self.base.labels)[idx])
            emitted += take


class BenchmarkDataSetIterator(DataSetIterator):
    """One synthetic batch repeated `num_batches` times (isolates compute
    from data loading): uniform fp32 features and one-hot labels from
    numpy's RandomState(seed), as in the JAX package."""

    def __init__(self, feature_shape, num_classes: int, num_batches: int,
                 seed: int = 42, label_shape=None):
        rng = np.random.RandomState(seed)
        self.features = rng.rand(*feature_shape).astype(np.float32)
        if label_shape is None:
            label_shape = (feature_shape[0], num_classes)
        labels = np.zeros(label_shape, np.float32)
        cls = rng.randint(0, num_classes, size=feature_shape[0])
        if len(label_shape) == 2:
            labels[np.arange(feature_shape[0]), cls] = 1.0
        else:
            labels[np.arange(feature_shape[0]), cls, :] = 1.0
        self.labels = labels
        self.num_batches = int(num_batches)

    def __iter__(self):
        for _ in range(self.num_batches):
            yield DataSet(self.features, self.labels)


class AsyncDataSetIterator(DataSetIterator):
    """The underlying iterator run in a background thread, at most
    `queue_size` DataSets ahead of the consumer. An error in the thread is
    raised in the consumer; a consumer that stops early releases the
    thread."""
    async_supported = False  # not wrapped twice

    def __init__(self, underlying, queue_size: int = 4):
        self.underlying = underlying
        self.queue_size = int(queue_size)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        end = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone: a full
            # queue would otherwise park the thread forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for ds in self.underlying:
                    if stop.is_set() or not put(ds):
                        return
            except BaseException as e:       # raised in the consumer
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
        if err:
            raise err[0]

    def reset(self):
        self.underlying.reset()
