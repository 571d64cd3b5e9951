"""Int8 quantization for the serving path (counterpart of serving/quant.py).

Two independent knobs, both default off:

- KV-cache quantization (`DL4J_TPU_KV_QUANT` / `ServingEngine(kv_quant=)`):
  the paged pool stores int8 payloads with PER-HEAD-PER-BLOCK symmetric
  scales (`scale = amax / 127` over each block's (block_size, head_dim)
  slice) in side tensors (n_layers, num_blocks + 1, n_kv_heads). Writes
  quantize (serving/kv_cache.py); reads dequantize inside the decode
  kernels (ops/csrc/flash_decode_paged.cu) or per gathered block in the
  plain versions. A dequantized pool is never materialized.
- Weight-only int8 (`DL4J_TPU_W8` / `ServingEngine(quant_weights=)`): the
  attention projections w_q/w_k/w_v/w_o store int8 weights with
  per-output-channel scales; activations stay float and the product is
  `(x @ w_int8) * scale`.

All quantize/dequantize arithmetic runs in float32 whatever the session
dtype, and `torch.round` rounds half to even as `jnp.round` does, so the
int8 payloads and scales are bit-identical to the JAX package's for the
same input. The read-modify-write cache paths rely on

    round((q * s) / s) == q  for every int8 q and float32 s > 0,

so a dequantize -> requantize round trip at an unchanged scale reproduces
the payload exactly.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

SCALE_DTYPE = torch.float32
PAYLOAD_DTYPE = torch.int8
QMAX = 127.0


def resolve_kv_quant(kv_quant: Optional[bool]) -> bool:
    """Effective KV-quantization flag: an explicit value beats the
    `DL4J_TPU_KV_QUANT` env knob (default off)."""
    if kv_quant is None:
        return os.environ.get("DL4J_TPU_KV_QUANT", "0") \
            not in ("", "0", "off")
    return bool(kv_quant)


def resolve_quant_weights(quant_weights: Optional[bool]) -> bool:
    """Effective weight-only-int8 flag: an explicit value beats the
    `DL4J_TPU_W8` env knob (default off)."""
    if quant_weights is None:
        return os.environ.get("DL4J_TPU_W8", "0") not in ("", "0", "off")
    return bool(quant_weights)


def kv_quantize(x: torch.Tensor):
    """Quantize KV blocks x (..., block_size, Hk, D) to int8 with
    per-head-per-block symmetric scales. Returns (payload int8 of x's
    shape, scales (..., Hk) float32). An all-zero slice gets scale 1.0."""
    xf = x.to(SCALE_DTYPE)
    amax = xf.abs().amax(dim=(-3, -1))                     # (..., Hk)
    scale = torch.where(amax > 0, amax / QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, :, None]), -QMAX, QMAX)
    return q.to(PAYLOAD_DTYPE), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize int8 KV blocks q (..., block_size, Hk, D) with scales
    (..., Hk) to float32."""
    return q.to(SCALE_DTYPE) * scale[..., None, :, None].to(SCALE_DTYPE)


def quantize_weight(w: torch.Tensor):
    """Quantize a (n_in, n_out) weight to int8 with per-output-channel
    symmetric scales: (w_int8, (n_out,) float32 scales)."""
    wf = w.to(SCALE_DTYPE)
    amax = wf.abs().amax(dim=0)                            # (n_out,)
    scale = torch.where(amax > 0, amax / QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[None, :]), -QMAX, QMAX)
    return q.to(PAYLOAD_DTYPE), scale


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor):
    """Weight-only int8 product y = (x @ w_int8) * scale, with the
    per-channel dequantize folded into one multiply on the output.
    Activations and accumulation stay float (>= float32); returns
    x.dtype. A plain product outside any kernel, as in the JAX package."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.matmul(x.to(acc), w_q.to(acc))
    return (y * scale.to(acc)).to(x.dtype)
