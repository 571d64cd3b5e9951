"""Gradient-sharing accumulators and threshold compression (counterpart of
parallel/accumulation.py).

The reference's GradientsAccumulator API (EncodedGradientsAccumulator,
EncodingHandler): each worker stores its update, and the accumulator hands
back the aggregate to apply. The threshold compressor quantizes each
stored update to a sparse {-t, 0, +t} message and keeps what it did not
send in a per-worker residual (Strom-style 1-bit SGD). As in the JAX
package, the exchange is synchronous: no staleness.

`threshold_encode_list` dispatches by device, as the JAX package's encoder
dispatches through its helper seam: on the card a list of tensors (a
data-parallel step's parameter tensors, or the flat gradient of
`EncodedGradientsAccumulator`) is one K11 launch
(`ops/threshold_encode.py`), where the JAX package takes its Pallas kernel
for 1-D inputs with its helpers on and its inline form otherwise; the port
runs its kernel on every device, as it does K10. On the CPU each tensor
runs the plain version. `threshold_encode` is the one-tensor case.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.helpers import helper_for
from deeplearning4j_tpu_torch.ops.threshold_encode import \
    threshold_encode_list_plain


def threshold_encode_list(updates, residuals, threshold: float):
    """Quantize each update + residual to {-t, 0, +t}; the remainders stay
    in the residuals. Returns ([message], [new_residual]), each in its
    update's shape; one K11 launch on the card."""
    if not updates:
        return [], []
    encode = helper_for("threshold_encode", threshold_encode_list_plain,
                        updates[0])
    return encode(updates, residuals, float(threshold))


def threshold_encode(update: torch.Tensor, residual: torch.Tensor,
                     threshold: float):
    """`threshold_encode_list` of one tensor: (message, new_residual)."""
    msgs, res = threshold_encode_list([update], [residual], threshold)
    return msgs[0], res[0]


def sum_in_order(xs):
    """xs[0] + xs[1] + ... on xs[0]'s device: a fixed order, so that
    repeated runs are bitwise equal."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x.to(out.device)
    return out


class GradientsAccumulator:
    """Base API: store updates, hand back the aggregate to apply."""

    def store_update(self, flat_grads: torch.Tensor, party: int = 0) -> None:
        """Store one worker's update. `party` identifies the worker, so that
        a stateful encoder keeps one residual per worker."""
        raise NotImplementedError

    def get_update(self) -> torch.Tensor:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class BasicGradientsAccumulator(GradientsAccumulator):
    """Identity accumulator: the mean of the updates stored since the last
    `get_update`."""

    def __init__(self, parties: int = 1):
        self.parties = parties
        self._stored = []

    def store_update(self, flat_grads, party: int = 0):
        self._stored.append(flat_grads)

    def get_update(self):
        if not self._stored:
            raise ValueError("No updates stored")
        agg = sum_in_order(self._stored) / len(self._stored)
        self._stored = []
        return agg

    def reset(self):
        self._stored = []


class EncodedGradientsAccumulator(GradientsAccumulator):
    """Threshold-compressed accumulator: each stored update is encoded
    against the current threshold with its party's residual; `get_update`
    returns the sum of the messages (what the workers would broadcast) and
    then decays the threshold once, never below `min_threshold`."""

    def __init__(self, parties: int = 1, threshold: float = 1e-3,
                 threshold_decay: float = 1.0, min_threshold: float = 1e-5):
        self.parties = parties
        self.threshold = float(threshold)
        self.threshold_decay = float(threshold_decay)
        self.min_threshold = float(min_threshold)
        self._residuals: dict = {}       # party -> residual, flat order
        self._stored = []

    def store_update(self, flat_grads, party: int = 0):
        residual = self._residuals.get(party)
        if residual is None:
            residual = torch.zeros_like(flat_grads)
        message, self._residuals[party] = threshold_encode(
            flat_grads, residual, self.threshold)
        self._stored.append(message)

    def get_update(self):
        if not self._stored:
            raise ValueError("No updates stored")
        out = sum_in_order(self._stored)
        self._stored = []
        # one decay per aggregation round, not one per party's store
        self.threshold = max(self.min_threshold,
                             self.threshold * self.threshold_decay)
        return out

    def reset(self):
        self._stored = []
        self._residuals = {}
