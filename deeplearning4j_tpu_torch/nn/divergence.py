"""Divergence-sentinel bookkeeping (counterpart of nn/divergence.py).

The `fit_on_device` loop carries a first-bad-step index (`div`, -1 =
clean) as a tensor on the device, with no host sync inside the loop.
`sync=True` resolves it at the end of the call (one readback, and a
warning at once); `sync=False` stashes the device scalar and resolves it
on the first `_diverged_at` access. Back-to-back deferred calls merge
stickily on the device (`where(prev >= 0, prev, new)`): a later clean call
must not clobber a divergence nobody has looked at yet."""
from __future__ import annotations

import warnings

import torch


class DivergenceSentinelMixin:
    _pending_div = None       # device scalar: first bad step, -1 = clean
    _diverged_at_v = None     # resolved host value (int step or None)

    def _stash_pending_div(self, div: torch.Tensor):
        """Record a new device-side sentinel, keeping an unobserved one."""
        if self._pending_div is not None:
            prev = self._pending_div
            div = torch.where(prev >= 0, prev, div)
        self._pending_div = div

    def _resolve_divergence(self, div: int):
        self._pending_div = None
        self._diverged_at_v = div if div >= 0 else None
        if self._diverged_at_v is not None:
            warnings.warn(
                f"Training diverged: non-finite loss at step "
                f"{self._diverged_at_v}; parameters frozen at the last "
                f"finite step")

    @property
    def _diverged_at(self):
        if self._pending_div is not None:
            self._resolve_divergence(int(self._pending_div))
        return self._diverged_at_v

    @_diverged_at.setter
    def _diverged_at(self, v):
        self._pending_div = None
        self._diverged_at_v = v
