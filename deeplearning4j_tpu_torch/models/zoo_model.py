"""Model zoo base class (counterpart of models/zoo_model.py).

Pretrained weights load through the model serializer, which is not ported
yet: `init_pretrained` raises NotImplementedError.
"""
from __future__ import annotations

from typing import Sequence


class ZooModel:
    """Subclasses implement conf() and init()."""

    def __init__(self, num_labels: int = 1000, seed: int = 123):
        self.num_labels = num_labels
        self.seed = seed
        self.input_shape: Sequence[int] = (3, 224, 224)

    def conf(self):
        raise NotImplementedError

    def init(self, device="cuda"):
        raise NotImplementedError

    def init_pretrained(self, pretrained_type: str = "imagenet"):
        raise NotImplementedError(
            "pretrained weights load through util/model_serializer.py, "
            "which is not ported to deeplearning4j_tpu_torch yet (ROADMAP.md)")
