"""Sync-free metrics registry, copied from telemetry/registry.py (counters,
gauges and fixed-bucket histograms).

Every metric is fed from values the caller already holds on the host, so
recording a metric never reads the device. The Prometheus exposition,
parent registries and last-update stamps of the JAX package are not
ported; the serving engine's `stats()` reads these metrics directly.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# default latency buckets (milliseconds)
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10000, 30000, 60000)
# default duration buckets (seconds): TTFT / request-level spans
DEFAULT_S_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1, 2.5, 5, 10, 30, 60)
_RING = 1024              # exact-quantile window per histogram


class Counter:
    """Monotonic (resettable) event counter. Single-writer, lock-free."""
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    def reset(self, value: int = 0) -> None:
        self._value = int(value)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-set instantaneous value. Lock-free."""
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def reset(self, value: float = 0.0) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with a preallocated ring buffer of recent raw
    observations (exact quantiles over the last `_RING` samples)."""
    __slots__ = ("name", "help", "bounds", "_counts", "_sum", "_ring",
                 "_written")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in buckets))
        self._counts = np.zeros(len(self.bounds) + 1, np.int64)
        self._sum = 0.0
        self._ring = np.zeros(_RING, np.float64)
        self._written = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self._counts[bisect.bisect_left(self.bounds, v)] += 1
        self._sum += v
        self._ring[self._written % _RING] = v
        self._written += 1

    def reset(self) -> None:
        self._counts[:] = 0
        self._sum = 0.0
        self._written = 0

    @property
    def count(self) -> int:
        return int(self._counts.sum())

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        n = min(self._written, _RING)
        if n == 0:
            return None
        window = np.sort(self._ring[:n])
        idx = min(n - 1, max(0, int(math.ceil(q * n)) - 1))
        return float(window[idx])

    def snapshot(self) -> dict:
        out = {"count": self.count, "sum": round(self._sum, 6)}
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            v = self.quantile(q)
            out[key] = None if v is None else round(v, 6)
        return out


class MetricsRegistry:
    """Get-or-create home for named metrics ("serving.host_syncs")."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()           # registration only

    def _get_or_create(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self) -> None:
        """Zero every metric (warm-up exclusion)."""
        for m in list(self._metrics.values()):
            m.reset()

    def snapshot(self) -> Dict[str, object]:
        return {name: m.snapshot() if isinstance(m, Histogram) else m.value
                for name, m in list(self._metrics.items())}
