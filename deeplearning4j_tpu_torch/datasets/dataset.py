"""DataSet container (counterpart of datasets/dataset.py): features,
labels and optional per-example or per-timestep masks, as numpy arrays or
tensors. `MultiLayerNetwork.fit(DataSet)` and `fit(iterable of
DataSets)` read it."""
from __future__ import annotations


class DataSet:
    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask

    def num_examples(self) -> int:
        return int(self.features.shape[0])
