"""Single-query decode attention over the paged KV pool (counterpart of
ops/decode_attention.py).

- `decode_attention_dense` / `decode_attention_dense_paged`: the plain
  PyTorch versions (gather through the block table, then dense masked
  softmax attention), the same math as the JAX package's oracles. The CPU
  path and the tests use them; on the card they are only the yardstick the
  kernel is checked against.
- `flash_decode_attention_paged`: the wrapper of the hand-written CUDA
  kernel `csrc/flash_decode_paged.cu` (the port of the Pallas kernel K1).
  One CTA per (slot, kv head, logical block) emits a normalized partial and
  its log-sum-exp; `merge_partials` combines them with the logaddexp
  algebra of the JAX package (:389-:394). On a CPU tensor the wrapper runs
  the plain version; on a CUDA tensor it launches the kernel or raises.

Shapes: q (S, H, D); kp/vp (NB+1, bs, Hk, D) physical blocks, the last one
the trash block; block_tables (S, bps) int32; visible (S,) int32 (position
index + 1); window > 0 is a sliding window (the query at visible-1 sees keys
j with visible-1-j < window). An int8 pool passes k_scale/v_scale
(NB+1, Hk) float32, applied per gathered block.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import register_helper

NEG_INF = -1e30
SOURCE = "flash_decode_paged.cu"
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.int8: 3}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def decode_attention_dense(q, kc, vc, visible, scale, window: int = 0):
    """Dense single-query attention against a contiguous (S, L, Hk, D)
    cache. Returns (S, H, D) in q.dtype."""
    S, H, D = q.shape
    L, Hk = kc.shape[1], kc.shape[2]
    if H % Hk != 0:
        raise ValueError(f"n_heads {H} % n_kv_heads {Hk} != 0")
    G = H // Hk
    acc = _acc_dtype(q.dtype)
    q4 = q.reshape(S, Hk, G, D)
    s = torch.einsum("shgd,slhd->shgl", q4.to(acc), kc.to(acc)) * scale
    j = torch.arange(L, device=q.device)[None, :]
    vis = visible.to(torch.int64)[:, None]
    valid = j < vis                                   # (S, L)
    if window:
        valid = valid & (vis - 1 - j < window)
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~valid, 0.0)
    out = torch.einsum("shgl,slhd->shgd", p, vc.to(acc))
    return out.reshape(S, H, D).to(q.dtype)


def decode_attention_dense_paged(q, kp, vp, block_tables, visible, scale,
                                 window: int = 0, k_scale=None, v_scale=None):
    """The plain version of the paged kernel: gather each slot's cache
    through its block table into (S, L, Hk, D), then the dense math. An
    int8 pool is dequantized per gathered block, never as a whole pool."""
    S = q.shape[0]
    bs, Hk, D = kp.shape[1], kp.shape[2], kp.shape[3]
    bps = block_tables.shape[1]
    bt = block_tables.long()
    if k_scale is not None:
        acc = _acc_dtype(q.dtype)
        kc = kp[bt].to(acc) * k_scale[bt][:, :, None, :, None].to(acc)
        vc = vp[bt].to(acc) * v_scale[bt][:, :, None, :, None].to(acc)
    else:
        kc, vc = kp[bt], vp[bt]
    return decode_attention_dense(q, kc.reshape(S, bps * bs, Hk, D),
                                  vc.reshape(S, bps * bs, Hk, D), visible,
                                  scale, window)


def merge_partials(o_p, l_p, dtype):
    """Logaddexp merge of per-block partials: o_p (S, Hk, bps, G, D),
    l_p (S, Hk, bps, G) -> (S, Hk*G, D) in `dtype`. Skipped blocks carry
    L_p = NEG_INF and weigh zero."""
    S, Hk, _, G, D = o_p.shape
    m = l_p.amax(dim=2, keepdim=True)                 # (S, Hk, 1, G)
    w = torch.exp(l_p - m.clamp(min=NEG_INF))         # (S, Hk, bps, G)
    denom = w.sum(dim=2).clamp(min=1e-30)             # (S, Hk, G)
    out = torch.einsum("shkg,shkgd->shgd", w, o_p) / denom[..., None]
    return out.reshape(S, Hk * G, D).to(dtype)


def _library():
    lib = build.load(SOURCE)
    fn = lib.dl4j_flash_decode_paged
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_decode_attention_paged(q, kp, vp, block_tables, visible, scale,
                                 window: int = 0, k_scale=None, v_scale=None):
    """Paged split-K flash-decode; same contract as
    `decode_attention_dense_paged`. CPU tensors run the plain version; CUDA
    tensors launch the CUDA kernel on the current stream (no sync, counted
    in `flash_decode_attention_paged.launches`) and merge its partials."""
    if q.device.type != "cuda":
        return decode_attention_dense_paged(q, kp, vp, block_tables, visible,
                                            scale, window, k_scale=k_scale,
                                            v_scale=v_scale)
    o_p, l_p = flash_decode_partials(q, kp, vp, block_tables, visible, scale,
                                     window, k_scale, v_scale)
    return merge_partials(o_p, l_p, q.dtype)


def flash_decode_partials(q, kp, vp, block_tables, visible, scale,
                          window: int = 0, k_scale=None, v_scale=None):
    """Launch the CUDA kernel on CUDA tensors: per-block partials
    (o_p (S, Hk, bps, G, D), l_p (S, Hk, bps, G)) in float32. Checks
    device, dtype, shape and contiguity and raises on what the kernel does
    not take; a refused launch raises too."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_partials runs on CUDA tensors only")
    S, H, D = q.shape
    _, bs, Hk, Dk = kp.shape
    bps = block_tables.shape[1]
    quantized = k_scale is not None
    if H % Hk != 0:
        raise ValueError(f"n_heads {H} % n_kv_heads {Hk} != 0")
    if Dk != D or vp.shape != kp.shape or block_tables.shape[0] != S \
            or visible.shape != (S,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, kp "
                         f"{tuple(kp.shape)}, vp {tuple(vp.shape)}, "
                         f"block_tables {tuple(block_tables.shape)}, visible "
                         f"{tuple(visible.shape)}")
    if q.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} not supported on the card "
                        "(float32, float16, bfloat16)")
    if quantized:
        if kp.dtype != torch.int8 or vp.dtype != torch.int8 \
                or v_scale is None:
            raise TypeError("an int8 pool needs int8 kp/vp and both scales")
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
        if k_scale.shape != (kp.shape[0], Hk) \
                or v_scale.shape != k_scale.shape:
            raise ValueError(f"scales must be {(kp.shape[0], Hk)}")
    elif kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"pool dtype {kp.dtype} must match q dtype {q.dtype}")
    tensors = [q, kp, vp, block_tables, visible] + (
        [k_scale, v_scale] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    q = q.contiguous()
    kp, vp = kp.contiguous(), vp.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    vis = visible.to(torch.int32).contiguous()
    G = H // Hk
    o_p = torch.empty((S, Hk, bps, G, D), dtype=torch.float32,
                      device=q.device)
    l_p = torch.empty((S, Hk, bps, G), dtype=torch.float32, device=q.device)
    lib = _library()
    err = lib.dl4j_flash_decode_paged(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        bt.data_ptr(), vis.data_ptr(), o_p.data_ptr(), l_p.data_ptr(),
        S, Hk, G, D, bs, bps, int(window), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[kp.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_decode_attention_paged launch failed: "
                           f"{lib.dl4j_cuda_error_string(err).decode()}")
    flash_decode_attention_paged.launches += 1
    return o_p, l_p


flash_decode_attention_paged.launches = 0
register_helper("decode_attention_paged")(flash_decode_attention_paged)
