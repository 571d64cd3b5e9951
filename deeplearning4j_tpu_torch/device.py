"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a default
of ``"cuda"`` that raises when CUDA is absent, never a silent CPU fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` (None means ``"cuda"``); raises
    RuntimeError for a CUDA device when CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: deeplearning4j_tpu_torch runs on the "
            "GPU by default; pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
