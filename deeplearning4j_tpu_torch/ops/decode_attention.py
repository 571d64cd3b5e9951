"""Decode attention over the KV cache (counterpart of
ops/decode_attention.py): one query per slot (K1, K6) or Q consecutive
queries per slot (K2, speculative verification).

- `decode_attention_dense` / `decode_attention_dense_paged` /
  `decode_attention_dense_spec_paged`: the plain PyTorch versions (gather
  through the block table, then dense masked softmax attention), the same
  math as the JAX package's oracles. The CPU path and the tests use them;
  on the card they are only the yardstick the kernels are checked against.
- `flash_decode_attention_paged` (K1) and `flash_decode_attention_spec_paged`
  (K2): wrappers of the hand-written CUDA kernel `csrc/flash_decode_paged.cu`,
  one launch a call. One CTA per (partition of `paged_partition` whole
  blocks, kv head, slot) emits a normalized partial and its log-sum-exp
  for each of its Q x G query rows, and the last CTA of each (slot, kv
  head) to finish merges them in partition order with the logaddexp
  algebra of the JAX package (:389-:394, :579-:587), in the same launch.
  K1 is the Q = 1 case of the same kernel. `paged_partials_plain` is the
  plain split of the same plan, which `merge_partials` merges.
- `flash_decode_attention` (K6): split-K decode over a contiguous
  (S, L, Hk, D) cache with its own kernel, `csrc/flash_decode_contiguous.cu`:
  one CTA per (partition of `contiguous_partition` positions, kv head,
  slot), the logaddexp merge in the same launch (the last CTA of each
  (slot, kv head) to finish merges, in partition order).
  `contiguous_partials_plain` is the plain split of the same plan, which
  `merge_partials` merges.

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

from deeplearning4j_tpu_torch.ops import build, helpers
from deeplearning4j_tpu_torch.ops.helpers import register_helper

NEG_INF = -1e30
SOURCE = "flash_decode_paged.cu"                   # K1, K2
CONTIGUOUS_SOURCE = "flash_decode_contiguous.cu"   # K6
SOURCES = (SOURCE, CONTIGUOUS_SOURCE)
PARTITION = 64             # positions per CTA of K1, K2 and K6, where they fit
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
    """Logaddexp merge of per-partition partials over the partition axis:
    o_p (S, Hk, np, Q, G, D), l_p (S, Hk, np, Q, G) -> (S, Q, Hk*G, D) in
    `dtype` (Q = 1 for K1 and the plain K6 split). Skipped partitions
    carry L_p = NEG_INF and weigh zero."""
    m = l_p.amax(dim=2, keepdim=True)
    w = torch.exp(l_p - m.clamp(min=NEG_INF))
    denom = w.sum(dim=2).clamp(min=1e-30)
    S, Hk, _, Q, G, D = o_p.shape
    out = torch.einsum("shkqg,shkqgd->shqgd", w, o_p) / denom[..., None]
    return out.transpose(1, 2).reshape(S, Q, Hk * G, D).to(dtype)


# ------------------------------------------------------ paged cache (K1, K2)
def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def _row_bytes(D: int, elt: int) -> int:
    return _pad16(_pad16(D) * elt) + 16


def paged_smem_bytes(bs: int, bpp: int, D: int, q_elt: int,
                     kv_elt: int) -> int:
    """Dynamic shared memory of one K1/K2 CTA (csrc/flash_decode_paged.cu
    `smem_bytes`): a head (block ids, scales, 16 row maxima and sums, a
    flag), Pp = bpp * bs rounded up to 16 rows each of K and V in the
    pool's dtype (`kv_elt` bytes), 16 query rows in q's (`q_elt`), the
    16 x (Pp + 4) fp32 scores and, for 2-byte queries (the tensor-core
    path), the 16 x (Pp + 8) probabilities. A row holds D rounded up to
    16, padded to a multiple of 16 bytes plus 16."""
    P = _pad16(bpp * bs)
    head = _pad16(4 * (3 * bpp + 2 * 16 + 1))
    return (head + 2 * P * _row_bytes(D, kv_elt) + 16 * _row_bytes(D, q_elt)
            + 4 * 16 * (P + 4) + (2 * 16 * (P + 8) if q_elt == 2 else 0))


def paged_partition(bs: int, D: int, q_elt: int, kv_elt: int) -> int:
    """K1/K2's plan: whole KV blocks per CTA, about PARTITION positions
    (PARTITION // bs blocks, at least one), halved until the CTA fits the
    H100's shared memory. It does not depend on Q or G (the kernel takes
    query rows 16 at a time), so row i of K2 is K1 at visible + i; any
    bs runs, the last partition of a row may hold fewer blocks."""
    bpp = max(1, PARTITION // bs)
    while bpp > 1 and paged_smem_bytes(bs, bpp, D, q_elt, kv_elt) \
            > SMEM_LIMIT:
        bpp //= 2
    if paged_smem_bytes(bs, bpp, D, q_elt, kv_elt) > SMEM_LIMIT:
        raise ValueError(f"K1/K2: one block of {bs} positions at D {D} does "
                         "not fit one CTA's shared memory")
    return bpp


def paged_partials_plain(q, kp, vp, block_tables, visible, scale,
                         window: int = 0, k_scale=None, v_scale=None, *,
                         plan: int):
    """The plain version of K1/K2's split at `plan` blocks per partition:
    q (S, H, D) (K1) or (S, Q, H, D) (K2); for each partition and query
    row the normalized partial o_p (S, Hk, np, Q, G, D) and L_p = m + log
    l (S, Hk, np, Q, G) over the positions the row sees there, in the
    accumulation dtype; a row that sees none there, and every row of a
    skipped partition, is (0, NEG_INF), as the kernel writes them with the
    merge off. `merge_partials(o_p, l_p, dtype)` is the call's output
    (`[:, 0]` for K1)."""
    q4 = q[:, None] if q.dim() == 3 else q
    S, Q, H, D = q4.shape
    bs, Hk = kp.shape[1], kp.shape[2]
    bps = block_tables.shape[1]
    G, L = H // Hk, bps * bs
    P = plan * bs
    np_ = -(-bps // plan)
    acc = _acc_dtype(q.dtype)
    bt = block_tables.long()
    kc, vc = kp[bt].to(acc), vp[bt].to(acc)
    if k_scale is not None:
        kc = kc * k_scale[bt][:, :, None, :, None].to(acc)
        vc = vc * v_scale[bt][:, :, None, :, None].to(acc)
    pad = np_ * P - L
    kc = kc.reshape(S, L, Hk, D)
    vc = torch.nn.functional.pad(vc.reshape(S, L, Hk, D),
                                 (0, 0, 0, 0, 0, pad)).view(S, np_, P, Hk, D)
    q5 = q4.reshape(S, Q, Hk, G, D).to(acc)
    s = torch.einsum("sqhgd,slhd->shqgl", q5, kc) * scale
    j = torch.arange(L, device=q.device)[None, None, :]
    vis = visible.to(torch.int64)[:, None, None] \
        + torch.arange(Q, device=q.device)[None, :, None]
    valid = j < vis                                   # (S, Q, L)
    if window:
        valid = valid & (vis - 1 - j < window)
    s = torch.nn.functional.pad(s, (0, pad)).view(S, Hk, Q, G, np_, P)
    valid = torch.nn.functional.pad(valid, (0, pad)) \
        .view(S, 1, Q, 1, np_, P)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1)                                 # (S, Hk, Q, G, np)
    o = torch.einsum("shqgnp,snphd->shnqgd", p, vc) \
        / l.clamp(min=1e-30).permute(0, 1, 4, 2, 3)[..., None]
    any_ = valid.any(dim=-1).expand(S, Hk, Q, G, np_).permute(0, 1, 4, 2, 3)
    l_p = torch.where(any_, (m[..., 0] + torch.log(l)).permute(0, 1, 4, 2, 3),
                      torch.full_like(o[..., 0], NEG_INF))
    return o * any_[..., None], l_p


def _library():
    lib = build.load(SOURCE)
    fn = lib.dl4j_flash_decode_paged
    if fn.argtypes is None:
        # q, kp, vp, k_scale, v_scale, block_tables, visible, o_p, l_p,
        # tickets, out, 12 ints, scale, stream
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dl4j_flash_decode_paged_smem.argtypes = [ctypes.c_int] * 5
        lib.dl4j_flash_decode_paged_smem.restype = ctypes.c_int
        lib.dl4j_capture_id.argtypes = [ctypes.c_void_p]
        lib.dl4j_capture_id.restype = ctypes.c_ulonglong
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
            v_scale, merge: bool, wrapper):
    """K1/K2's kernel on CUDA tensors (the callers check the device), q
    (S, H, D) for K1 or (S, Q, H, D) for K2: one launch on the current
    stream, no sync, counted in `wrapper.launches`. With the merge on, the
    output in q's shape and dtype; off, the partials of
    `paged_partials_plain`'s layout in float32. Checks dtype, shape and
    contiguity and raises on what the kernel does not take; a refused
    launch raises too."""
    what = wrapper.__name__
    S, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Q = 1 if q.dim() == 3 else q.shape[1]
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
    G = H // Hk
    bpp = paged_partition(bs, D, q.element_size(), kp.element_size())
    np_ = -(-bps // bpp)
    q, kp, vp = q.contiguous(), kp.contiguous(), vp.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    vis = visible.to(torch.int32).contiguous()
    # one fp32 buffer: the partials, then their L_p
    n_o = S * Hk * np_ * Q * G * D
    scratch = torch.empty(n_o + n_o // D, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q) if merge else None
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = helpers.tickets(_TICKETS, S * Hk, q.device, stream, lib)
    err = lib.dl4j_flash_decode_paged(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        bt.data_ptr(), vis.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + 4 * n_o, tickets.data_ptr(),
        out.data_ptr() if merge else None, S, Q, Hk, G, D, bs, bps, bpp,
        int(window), int(bool(merge)), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[kp.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.dl4j_cuda_error_string(err).decode()}")
    wrapper.launches += 1
    if merge:
        return out
    return (scratch[:n_o].view(S, Hk, np_, Q, G, D),
            scratch[n_o:].view(S, Hk, np_, Q, G))


def flash_decode_attention_paged(q, kp, vp, block_tables, visible, scale,
                                 window: int = 0, k_scale=None, v_scale=None):
    """K1, paged split-K flash-decode; same contract as
    `decode_attention_dense_paged`. CPU tensors run the plain version; CUDA
    tensors launch the CUDA kernel once on the current stream, merge
    included (no sync; counted in `flash_decode_attention_paged.launches`)."""
    if q.device.type != "cuda":
        return decode_attention_dense_paged(q, kp, vp, block_tables, visible,
                                            scale, window, k_scale=k_scale,
                                            v_scale=v_scale)
    return _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
                   v_scale, True, flash_decode_attention_paged)


def flash_decode_partials(q, kp, vp, block_tables, visible, scale,
                          window: int = 0, k_scale=None, v_scale=None):
    """K1's kernel with the merge off, on CUDA tensors q (S, H, D): the
    per-partition partials (o_p (S, Hk, np, 1, G, D), l_p (S, Hk, np, 1,
    G)) in float32, as `paged_partials_plain` lays them out."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_partials runs on CUDA tensors only")
    return _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
                   v_scale, False, flash_decode_attention_paged)


flash_decode_attention_paged.launches = 0
register_helper("decode_attention_paged")(flash_decode_attention_paged)


def flash_decode_attention_spec_paged(q, kp, vp, block_tables, visible,
                                      scale, window: int = 0, k_scale=None,
                                      v_scale=None):
    """K2, the multi-query paged split-K flash-decode of speculative
    verification; same contract as `decode_attention_dense_spec_paged`
    (q (S, Q, H, D), query i sees j < visible + i). CPU tensors run the
    plain version; CUDA tensors launch the kernel once for all Q queries,
    merge included (counted in `flash_decode_attention_spec_paged
    .launches`), so each K/V element is read once per call whatever Q is.
    Any block size runs on the kernel (the TPU's bs < 8 dense fallback was
    a tiling limit)."""
    if q.device.type != "cuda":
        return decode_attention_dense_spec_paged(
            q, kp, vp, block_tables, visible, scale, window,
            k_scale=k_scale, v_scale=v_scale)
    return _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
                   v_scale, True, flash_decode_attention_spec_paged)


def flash_decode_spec_partials(q, kp, vp, block_tables, visible, scale,
                               window: int = 0, k_scale=None, v_scale=None):
    """K2's kernel with the merge off, on CUDA tensors q (S, Q, H, D): the
    per-partition partials (o_p (S, Hk, np, Q, G, D), l_p (S, Hk, np, Q,
    G)) in float32, as `paged_partials_plain` lays them out."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_spec_partials runs on CUDA tensors "
                         "only")
    return _launch(q, kp, vp, block_tables, visible, scale, window, k_scale,
                   v_scale, False, flash_decode_attention_spec_paged)


flash_decode_attention_spec_paged.launches = 0
register_helper("decode_attention_spec_paged")(
    flash_decode_attention_spec_paged)


# ------------------------------------------------------ contiguous cache (K6)
def contiguous_smem_bytes(G: int, D: int, P: int, elt: int) -> int:
    """Dynamic shared memory of one K6 CTA (csrc/flash_decode_contiguous.cu
    `smem_bytes`): the G query rows and G x P scores in fp32, the rows'
    max and sum and a flag, then P rows each of K and V in their dtype
    (`elt` bytes), a row padded to a multiple of 16 bytes plus 16."""
    head = (4 * (G * D + G * P + 2 * G + 1) + 15) // 16 * 16
    return head + 2 * P * ((D * elt + 15) // 16 * 16 + 16)


def contiguous_partition(G: int, D: int, elt: int) -> int:
    """K6's positions per CTA: PARTITION, halved until its CTA fits the
    H100's shared memory. Any L runs (a ragged last partition is masked),
    and the merge makes the values independent of the partition."""
    P = PARTITION
    while P > 1 and contiguous_smem_bytes(G, D, P, elt) > SMEM_LIMIT:
        P //= 2
    if contiguous_smem_bytes(G, D, P, elt) > SMEM_LIMIT:
        raise ValueError(f"K6: G {G} x D {D} does not fit one CTA's shared "
                         "memory")
    return P


def contiguous_partials_plain(q, kc, vc, visible, scale, window: int = 0,
                              P: int = PARTITION):
    """The plain version of K6's split: for each partition of P positions,
    the normalized partial o_p (S, Hk, np, G, D) and L_p = m + log l (S, Hk,
    np, G) over its visible positions, in the accumulation dtype;
    partitions with none are (0, NEG_INF), as the kernel writes them with
    the merge off. `merge_partials(o_p[:, :, :, None], l_p[:, :, :, None],
    dtype)[:, 0]` is then K6's output."""
    S, H, D = q.shape
    L, Hk = kc.shape[1], kc.shape[2]
    G = H // Hk
    acc = _acc_dtype(q.dtype)
    np_ = -(-L // P)
    q4 = q.reshape(S, Hk, G, D).to(acc)
    s = torch.einsum("shgd,slhd->shgl", q4, kc.to(acc)) * scale
    j = torch.arange(L, device=q.device)[None, :]
    vis = visible.to(torch.int64)[:, None]
    valid = j < vis
    if window:
        valid = valid & (vis - 1 - j < window)
    pad = np_ * P - L
    s = torch.nn.functional.pad(s, (0, pad)).view(S, Hk, G, np_, P)
    valid = torch.nn.functional.pad(valid, (0, pad)).view(S, 1, 1, np_, P)
    v = torch.nn.functional.pad(vc.to(acc), (0, 0, 0, 0, 0, pad)) \
        .view(S, np_, P, Hk, D)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1)
    o = torch.einsum("shgnp,snphd->shngd", p, v) \
        / l.clamp(min=1e-30).transpose(2, 3)[..., None]
    any_ = valid.any(dim=-1).transpose(2, 3)       # (S, 1, np, 1)
    l_p = torch.where(any_, (m[..., 0] + torch.log(l)).transpose(2, 3),
                      torch.full_like(o[..., 0], NEG_INF))
    return o * any_[..., None], l_p


_TICKETS = {}          # K1, K2 and K6's tickets (`helpers.tickets`)


def _contiguous_library():
    lib = build.load(CONTIGUOUS_SOURCE)
    fn = lib.dl4j_flash_decode_contiguous
    if fn.argtypes is None:
        # q, kc, vc, visible, o_p, l_p, tickets, out, 9 ints, scale, stream
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dl4j_flash_decode_contiguous_smem.argtypes = [ctypes.c_int] * 4
        lib.dl4j_flash_decode_contiguous_smem.restype = ctypes.c_int
        lib.dl4j_capture_id.argtypes = [ctypes.c_void_p]
        lib.dl4j_capture_id.restype = ctypes.c_ulonglong
        err = lib.dl4j_flash_decode_contiguous_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _contiguous_launch(q, kc, vc, visible, scale, window, merge: bool):
    """K6's kernel on CUDA tensors: the output (S, H, D) in q.dtype with the
    merge on, else the partials (o_p, l_p) of `contiguous_partials_plain`'s
    layout in float32. One launch on the current stream, no sync, counted
    in `flash_decode_attention.launches`."""
    S, H, D = q.shape
    L, Hk = kc.shape[1], kc.shape[2]
    if H % Hk != 0:
        raise ValueError(f"n_heads {H} % n_kv_heads {Hk} != 0")
    if vc.shape != kc.shape or kc.shape[0] != S or kc.shape[3] != D \
            or visible.shape != (S,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, kc "
                         f"{tuple(kc.shape)}, vc {tuple(vc.shape)}, visible "
                         f"{tuple(visible.shape)}")
    if q.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} not supported on the card "
                        "(float32, float16, bfloat16)")
    if kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"cache dtype {kc.dtype} must match q dtype "
                        f"{q.dtype}")
    if any(t.device != q.device for t in (kc, vc, visible)):
        raise ValueError("all inputs must lie on one CUDA device")
    G = H // Hk
    P = contiguous_partition(G, D, q.element_size())
    np_ = -(-L // P)
    q, kc, vc = q.contiguous(), kc.contiguous(), vc.contiguous()
    vis = visible.to(torch.int32).contiguous()
    o_p = torch.empty((S, Hk, np_, G, D), dtype=torch.float32,
                      device=q.device)
    l_p = torch.empty((S, Hk, np_, G), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _contiguous_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = helpers.tickets(_TICKETS, S * Hk, q.device, stream, lib)
    err = lib.dl4j_flash_decode_contiguous(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), vis.data_ptr(),
        o_p.data_ptr(), l_p.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        S, L, Hk, G, D, P, int(window), int(bool(merge)),
        _DTYPE_CODE[q.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(
            "flash_decode_attention launch failed: "
            f"{lib.dl4j_flash_decode_contiguous_error_string(err).decode()}")
    flash_decode_attention.launches += 1
    return out if merge else (o_p, l_p)


def flash_decode_attention(q, kc, vc, visible, scale, window: int = 0):
    """K6, split-K flash-decode over a contiguous cache; same contract as
    `decode_attention_dense` (q (S, H, D), kc/vc (S, L, Hk, D), visible
    (S,)). CPU tensors run the plain version; CUDA tensors launch K6's
    kernel once, merge included (counted in
    `flash_decode_attention.launches`)."""
    if q.device.type != "cuda":
        return decode_attention_dense(q, kc, vc, visible, scale, window)
    return _contiguous_launch(q, kc, vc, visible, scale, window, True)


def flash_decode_contiguous_partials(q, kc, vc, visible, scale,
                                     window: int = 0):
    """K6's kernel with the merge off, on CUDA tensors: the per-partition
    partials (o_p (S, Hk, np, G, D), l_p (S, Hk, np, G)) in float32, as
    `contiguous_partials_plain` lays them out."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_contiguous_partials runs on CUDA "
                         "tensors only")
    return _contiguous_launch(q, kc, vc, visible, scale, window, False)


flash_decode_attention.launches = 0
register_helper("decode_attention")(flash_decode_attention)
