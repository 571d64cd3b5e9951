from deeplearning4j_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_MS_BUCKETS, DEFAULT_S_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry)
