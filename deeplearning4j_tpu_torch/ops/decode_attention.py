"""Decode attention over the KV cache (counterpart of
ops/decode_attention.py): one query per slot (K1, K6) or Q consecutive
queries per slot (K2, speculative verification).

- `decode_attention_dense` / `decode_attention_dense_paged` /
  `decode_attention_dense_spec_paged`: the plain PyTorch versions (gather
  through the block table, then dense masked softmax attention), the same
  math as the JAX package's oracles. The CPU path and the tests use them;
  on the card they are only the yardstick the kernels are checked against.
- `flash_decode_attention_paged` (K1) and `flash_decode_attention_spec_paged`
  (K2): wrappers of the hand-written CUDA kernel `csrc/flash_decode_paged.cu`.
  One CTA per (logical block, kv head, slot) emits a normalized partial and
  its log-sum-exp for each of its Q x G query rows; `merge_partials`
  combines them with the logaddexp algebra of the JAX package (:389-:394,
  :579-:587). K1 is the Q = 1 case of the same kernel.
- `flash_decode_attention` (K6): split-K decode over a contiguous
  (S, L, Hk, D) cache, launched on the same kernel: the cache viewed as
  S * nk physical blocks of bkv positions, with the table bt[s, j] =
  s * nk + j (no copy, no trash block).

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.

Shapes: q (S, H, D), or (S, Q, H, D) for K2; kp/vp (NB+1, bs, Hk, D)
physical blocks, the last one the trash block; block_tables (S, bps)
int32; visible (S,) int32 (position index + 1 of query 0; query i of K2
sees j < visible + i); window > 0 is a sliding window (the query at
position p sees keys j with p - j < window). An int8 pool passes
k_scale/v_scale (NB+1, Hk) float32, applied per gathered block.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import register_helper

NEG_INF = -1e30
SOURCE = "flash_decode_paged.cu"
BKV = 256                  # K6's partition, as the JAX package resolves it
# shared memory a CTA may hold on the H100 (227 KB)
SMEM_LIMIT = 232448
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


def decode_attention_dense_spec_paged(q, kp, vp, block_tables, visible,
                                      scale, window: int = 0, k_scale=None,
                                      v_scale=None):
    """The plain version of K2: Q calls of the single-query plain paged
    version, query i at visible + i. Row i is therefore exactly what a
    sequential decode step would compute at that position. q (S, Q, H, D)
    -> (S, Q, H, D) in q.dtype."""
    visible = visible.to(torch.int32)
    return torch.stack(
        [decode_attention_dense_paged(q[:, i], kp, vp, block_tables,
                                      visible + i, scale, window,
                                      k_scale=k_scale, v_scale=v_scale)
         for i in range(q.shape[1])], dim=1)


def merge_partials(o_p, l_p, dtype):
    """Logaddexp merge of per-block partials over the block axis: o_p
    (S, Hk, bps, Q, G, D), l_p (S, Hk, bps, Q, G) -> (S, Q, Hk*G, D) in
    `dtype` (Q = 1 for K1 and K6). Skipped blocks carry L_p = NEG_INF and
    weigh zero."""
    m = l_p.amax(dim=2, keepdim=True)
    w = torch.exp(l_p - m.clamp(min=NEG_INF))
    denom = w.sum(dim=2).clamp(min=1e-30)
    S, Hk, _, Q, G, D = o_p.shape
    out = torch.einsum("shkqg,shkqgd->shqgd", w, o_p) / denom[..., None]
    return out.transpose(1, 2).reshape(S, Q, Hk * G, D).to(dtype)


def _library():
    lib = build.load(SOURCE)
    fn = lib.dl4j_flash_decode_paged
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(rows: int, D: int, bs: int) -> int:
    """Dynamic shared memory of one CTA of the kernel: the (rows, D) query
    tile, the (bs, D+1) K and (bs, D) V tiles, the (rows, bs) scores and
    two row statistics, all float32 (rows = Q * G)."""
    return 4 * (rows * D + bs * (D + 1) + bs * D + rows * bs + 2 * rows)


def _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
            v_scale, what: str):
    """Launch the CUDA kernel on q (S, Q, H, D): per-block partials
    (o_p (S, Hk, bps, Q, G, D), l_p (S, Hk, bps, Q, G)) in float32, on the
    current stream, without a sync. Checks device, dtype, shape and
    contiguity and raises on what the kernel does not take; a refused
    launch raises too."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors only")
    S, Q, H, D = q.shape
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
    o_p = torch.empty((S, Hk, bps, Q, G, D), dtype=torch.float32,
                      device=q.device)
    l_p = torch.empty((S, Hk, bps, Q, G), dtype=torch.float32,
                      device=q.device)
    lib = _library()
    err = lib.dl4j_flash_decode_paged(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        bt.data_ptr(), vis.data_ptr(), o_p.data_ptr(), l_p.data_ptr(),
        S, Q, Hk, G, D, bs, bps, int(window), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[kp.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.dl4j_cuda_error_string(err).decode()}")
    return o_p, l_p


def flash_decode_attention_paged(q, kp, vp, block_tables, visible, scale,
                                 window: int = 0, k_scale=None, v_scale=None):
    """K1, paged split-K flash-decode; same contract as
    `decode_attention_dense_paged`. CPU tensors run the plain version; CUDA
    tensors launch the CUDA kernel on the current stream (no sync, counted
    in `flash_decode_attention_paged.launches`) and merge its partials."""
    if q.device.type != "cuda":
        return decode_attention_dense_paged(q, kp, vp, block_tables, visible,
                                            scale, window, k_scale=k_scale,
                                            v_scale=v_scale)
    o_p, l_p = flash_decode_partials(q, kp, vp, block_tables, visible, scale,
                                     window, k_scale, v_scale)
    return merge_partials(o_p, l_p, q.dtype)[:, 0]


def flash_decode_partials(q, kp, vp, block_tables, visible, scale,
                          window: int = 0, k_scale=None, v_scale=None):
    """K1's kernel launch on CUDA tensors q (S, H, D): per-block partials
    (o_p (S, Hk, bps, 1, G, D), l_p (S, Hk, bps, 1, G)) in float32."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_partials runs on CUDA tensors only")
    o_p, l_p = _launch(q[:, None], kp, vp, block_tables, visible, scale,
                       window, k_scale, v_scale,
                       "flash_decode_attention_paged")
    flash_decode_attention_paged.launches += 1
    return o_p, l_p


flash_decode_attention_paged.launches = 0
register_helper("decode_attention_paged")(flash_decode_attention_paged)


def flash_decode_attention_spec_paged(q, kp, vp, block_tables, visible,
                                      scale, window: int = 0, k_scale=None,
                                      v_scale=None):
    """K2, the multi-query paged split-K flash-decode of speculative
    verification; same contract as `decode_attention_dense_spec_paged`
    (q (S, Q, H, D), query i sees j < visible + i). CPU tensors run the
    plain version; CUDA tensors launch the kernel once for all Q queries
    (counted in `flash_decode_attention_spec_paged.launches`), so each K/V
    element is read once per call whatever Q is, and merge its partials.
    Any block size runs on the kernel (the TPU's bs < 8 dense fallback was
    a tiling limit)."""
    if q.device.type != "cuda":
        return decode_attention_dense_spec_paged(
            q, kp, vp, block_tables, visible, scale, window,
            k_scale=k_scale, v_scale=v_scale)
    o_p, l_p = flash_decode_spec_partials(q, kp, vp, block_tables, visible,
                                          scale, window, k_scale, v_scale)
    return merge_partials(o_p, l_p, q.dtype)


def flash_decode_spec_partials(q, kp, vp, block_tables, visible, scale,
                               window: int = 0, k_scale=None, v_scale=None):
    """K2's kernel launch on CUDA tensors q (S, Q, H, D): per-block
    partials (o_p (S, Hk, bps, Q, G, D), l_p (S, Hk, bps, Q, G))."""
    out = _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
                  v_scale, "flash_decode_attention_spec_paged")
    flash_decode_attention_spec_paged.launches += 1
    return out


flash_decode_attention_spec_paged.launches = 0
register_helper("decode_attention_spec_paged")(
    flash_decode_attention_spec_paged)


# ------------------------------------------------------ contiguous cache (K6)
def kernel_bkv(L: int, G: int, D: int) -> int:
    """The partition K6's kernel runs: the largest size <= BKV that divides
    L (the JAX package's `_resolve_bkv(256, L)`: the cache is never copied
    or padded), lowered to the largest divisor of L whose CTA fits in
    shared memory. The merge makes the values independent of the
    partition size."""
    bkv = min(BKV, L)
    while bkv > 1 and L % bkv:
        bkv //= 2
    while bkv > 1 and smem_bytes(G, D, bkv) > SMEM_LIMIT:
        bkv = max(d for d in range(1, bkv) if L % d == 0)
    return bkv


def flash_decode_attention(q, kc, vc, visible, scale, window: int = 0):
    """K6, split-K flash-decode over a contiguous cache; same contract as
    `decode_attention_dense` (q (S, H, D), kc/vc (S, L, Hk, D), visible
    (S,)). CPU tensors run the plain version. On CUDA tensors the cache is
    viewed as S * nk blocks of `kernel_bkv` positions and K1's kernel runs
    on it with the table bt[s, j] = s * nk + j (counted in
    `flash_decode_attention.launches`); the partials merge as K1's. Any
    partition size runs on the kernel (the TPU's bkv < 8 dense fallback
    was a tiling limit)."""
    if q.device.type != "cuda":
        return decode_attention_dense(q, kc, vc, visible, scale, window)
    o_p, l_p = flash_decode_contiguous_partials(q, kc, vc, visible, scale,
                                                window)
    return merge_partials(o_p, l_p, q.dtype)[:, 0]


def flash_decode_contiguous_partials(q, kc, vc, visible, scale,
                                     window: int = 0):
    """K6's kernel launch on CUDA tensors: per-partition partials
    (o_p (S, Hk, nk, 1, G, D), l_p (S, Hk, nk, 1, G)) in float32."""
    S, H, D = q.shape
    L, Hk = kc.shape[1], kc.shape[2]
    if H % Hk != 0:
        raise ValueError(f"n_heads {H} % n_kv_heads {Hk} != 0")
    if vc.shape != kc.shape or kc.shape[0] != S:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, kc "
                         f"{tuple(kc.shape)}, vc {tuple(vc.shape)}")
    bkv = kernel_bkv(L, H // Hk, D)
    nk = L // bkv
    kp = kc.contiguous().view(S * nk, bkv, Hk, D)
    vp = vc.contiguous().view(S * nk, bkv, Hk, D)
    bt = torch.arange(S * nk, dtype=torch.int32,
                      device=q.device).view(S, nk)
    o_p, l_p = _launch(q[:, None], kp, vp, bt, visible, scale, window, None,
                       None, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return o_p, l_p


flash_decode_attention.launches = 0
register_helper("decode_attention")(flash_decode_attention)
