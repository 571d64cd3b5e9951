"""DataSet / MultiDataSet containers (counterpart of datasets/dataset.py):
features, labels and optional per-example or per-timestep masks, as numpy
arrays or tensors. `fit(DataSet)`, `fit(iterable of DataSets)` and
`ParallelWrapper` read them."""
from __future__ import annotations

from typing import List


def _rows(a, start: int, stop: int):
    return None if a is None else a[start:stop]


class DataSet:
    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        """Consecutive minibatches of `batch_size` examples (the last may
        be smaller)."""
        return [DataSet(*(_rows(a, i, i + batch_size) for a in (
                    self.features, self.labels, self.features_mask,
                    self.labels_mask)))
                for i in range(0, self.num_examples(), batch_size)]


class MultiDataSet:
    """Multiple inputs and outputs, one array per graph input / output
    (consumed by `ComputationGraph` and `ParallelWrapper`)."""

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None):
        self.features = list(features) if isinstance(
            features, (list, tuple)) else [features]
        self.labels = list(labels) if isinstance(labels, (list, tuple)) \
            else [labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
