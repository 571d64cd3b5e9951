"""Flash attention, forward and backward (counterpart of
ops/flash_attention.py): the long-context hot path of
`SelfAttentionLayer` at T > block_size.

Public functions keep the JAX package's layout, (B, H, T, D), and its
semantics:
- `flash_attention(q, k, v, mask, causal, scale, window, bwd)` and
  `flash_attention_lse(...)`, which also returns the row log-sum-exp
  (B, H, T) and is differentiable in both outputs (a cotangent on the
  lse shifts D_i, as in the JAX package);
- `flash_attention_reference`: the dense oracle;
- `configure(bwd=...)`: the backward schedule, "fused" (K4, default) or
  "two_pass" (K5), also read from DL4J_TPU_FLASH_BWD when the module is
  imported.

Masking: keys past T drop; `causal` keeps kj <= qi; `window` > 0 keeps
qi - window < kj <= qi (causal) or |qi - kj| < window (non-causal); a
(B, T) key mask drops keys whose mask is 0. Masked scores are NEG_INF =
-1e30 (never -inf). A row with no visible key gives o = 0 and L = NEG_INF,
and zero gradients. `scale` defaults to 1/sqrt(D). GQA: k/v may carry Hk |
H heads in the forward (query head h reads kv head h // (H / Hk)); the
grouped backward raises, as in the JAX package: the layer repeats k/v to
full heads before the call, so training never reaches it.

Kernels (CUDA C++ for sm_90a in two sources, chosen by dtype, kind and
head dim in `_route`: bf16 K3, K4 and K5 at a kernel head dim up to 512
take `csrc/flash_attention_sm90.cu` (wgmma, TMA; at 384 and 512 the split
kernels, whose two warpgroups share the head dim); fp32 inputs at every
head dim, and bf16 above 512, the CUDA-core kernels of
`csrc/flash_attention.cu` (bf16 widened to fp32 before the launch, the
outputs rounded back); each wrapper counts its launches per source in
`.route_launches`):
- K3 `flash_attention_fwd_cuda` replaces `_call_fwd` / `_fwd_kernel`;
- K4 `flash_attention_bwd_cuda(..., bwd="fused")` replaces
  `_fused_bwd_kernel`: one kernel per key tile giving dk, dv and each
  tile's dq, which it adds into one zeroed fp32 (B*H, T, D) buffer (bf16:
  reductions in L2; fp32: atomics), so there are no per-k-block partials;
- K5 `flash_attention_bwd_cuda(..., bwd="two_pass")` replaces `_dq_kernel`
  and `_dkv_kernel`.
Each has a plain PyTorch version with the kernel's own signature,
`flash_fwd_plain` and `flash_bwd_plain` (dense, fp32 scores, fp64 for
fp64 inputs); the backward recomputes p from the lse, as the kernels do.
One `torch.autograd.Function` takes each direction through
`ops/helpers.helper_for`: CUDA tensors get the kernel, CPU tensors the
plain version. D_i = rowsum(dO * o) - dlse is a torch reduction outside
the kernels, as it is an XLA reduction in the JAX package.

Head dims: the kernels are built for D in HEAD_DIMS (the wgmma kernels of
K3, K4 and K5 for all of them: SM90_MAX_D), and the fp32
kernels above 512 for any multiple of WIDE_CHUNK (kernels that stream the
head dim through shared memory in chunks of that many columns, with the
accumulators in the outputs' rows in device memory: a 16-row backward CTA
that held D 1024 would need ~266 KB of shared memory, above one CTA's 227
KB). The wrappers zero-pad any other D to the next kernel head dim
(`padded_fwd`, `padded_bwd`) and cut the outputs back, with the scale of
the true D. Padded columns add 0 to every score and every output, so the
result is exact. No head dim raises.

Left out of the port: the TPU tile arguments `bq`/`bk` (the CUDA kernels
pick their own tiles), the (B*H, nk, T, D) dq-partials buffer and its byte
cap, and `dq_partials="io"`, which raises. DL4J_TPU_FLASH_DQ_PARTIALS and
DL4J_TPU_FLASH_DQP_MAX_BYTES are not read.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import helper_for, register_helper

NEG_INF = -1e30
SOURCE = "flash_attention.cu"            # fp32 K3, K4 and K5
SM90_SOURCE = "flash_attention_sm90.cu"  # bf16 K3, K4 and K5 (wgmma, TMA)
SOURCES = (SOURCE, SM90_SOURCE)
BWD_MODES = ("fused", "two_pass")
HEAD_DIMS = (16, 32, 64, 128, 192, 256, 384, 512)   # of the kernels
WIDE_CHUNK = 128    # ... and above 512, every multiple of this
# the largest kernel head dim of the wgmma kernels (K3, K4 and K5)
SM90_MAX_D = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}

_CONFIG = {"bwd": os.environ.get("DL4J_TPU_FLASH_BWD", "fused")}


def _check_dq_partials(dq_partials: Optional[str]) -> None:
    if dq_partials not in (None, "acc"):
        raise NotImplementedError(
            f"dq_partials={dq_partials!r}: the port's fused backward "
            "adds dq into one fp32 buffer on the card (no per-k-block "
            "partials buffer, whose size 'io' bounds on the TPU); only "
            "'acc' exists")


def configure(bwd: Optional[str] = None, dq_partials: Optional[str] = None):
    """Set the default backward schedule ('fused' | 'two_pass'); returns the
    previous (bwd, dq_partials) pair. The default is read when
    `flash_attention` is called, so it takes effect for every later call.
    `dq_partials` exists for the JAX package's signature: 'acc' is the
    only mode, 'io' raises NotImplementedError."""
    _check_dq_partials(dq_partials)
    prev = (_CONFIG["bwd"], "acc")
    if bwd is not None:
        if bwd not in BWD_MODES:
            raise ValueError(f"unknown flash bwd mode {bwd!r}")
        _CONFIG["bwd"] = bwd
    return prev


def _resolve_bwd(bwd: Optional[str]) -> str:
    bwd = _CONFIG["bwd"] if bwd is None else bwd
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown flash bwd mode {bwd!r} (DL4J_TPU_FLASH_BWD "
                         f"or the bwd argument: {BWD_MODES})")
    return bwd


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _scale(scale, D: int) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def _check_shapes(q, k, v):
    B, H, T, D = q.shape
    Hk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != T \
            or k.shape[3] != D or H % Hk != 0:
        raise ValueError(
            f"bad GQA shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (need k == v, same B/T/D, and n_heads % "
            "n_kv_heads == 0)")


def _no_grouped_backward(q, k):
    if k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            f"flash_attention backward with grouped k/v heads "
            f"(H={q.shape[1]}, Hk={k.shape[1]}) is not implemented; "
            "repeat k/v to the full head count before differentiating")


def _valid(T: int, mask, causal: bool, window: int, device):
    """(B or 1, 1, T, T) bool: which (query, key) pairs are visible."""
    qi = torch.arange(T, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    valid = torch.ones((T, T), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (qi >= kj)
    if window:
        valid = valid & (qi - kj < window)
        if not causal:
            valid = valid & (kj - qi < window)
    valid = valid[None, None]
    if mask is not None:
        valid = valid & (mask > 0)[:, None, None, :]
    return valid


def _full_heads(q, k, v):
    H, Hk = q.shape[1], k.shape[1]
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    return k, v


# ------------------------------------------------------------ plain versions
def flash_fwd_plain(q, k, v, mask=None, causal: bool = False, scale=None,
                    window: int = 0):
    """The plain version of K3: dense attention with the kernel's masking.
    Returns (o (B, H, T, D) in q.dtype, lse (B, H, T) in the accumulation
    dtype: float32, float64 for float64 inputs)."""
    _check_shapes(q, k, v)
    acc = _acc_dtype(q.dtype)
    T, D = q.shape[2], q.shape[3]
    k, v = _full_heads(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) \
        * _scale(scale, D)
    valid = _valid(T, mask, causal, window, q.device)
    s = s.masked_fill(~valid, NEG_INF)
    any_valid = valid.any(dim=-1)                      # (B|1, 1, T)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp((s - lse[..., None]).masked_fill(~valid, float("-inf")))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))
    lse = torch.where(any_valid, lse, torch.full_like(lse, NEG_INF))
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, mask, o, lse, do, dlse=None,
                    causal: bool = False, scale=None, window: int = 0,
                    bwd: Optional[str] = None):
    """The plain version of K4 and K5 (they compute the same function):
    p recomputed from the lse, D_i = rowsum(dO * o) - dlse, then
    dv = p^T dO, ds = p * (dO v^T - D_i), dq = scale ds k, dk = scale ds^T q.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _resolve_bwd(bwd)
    _check_shapes(q, k, v)
    _no_grouped_backward(q, k)
    acc = _acc_dtype(q.dtype)
    T, D = q.shape[2], q.shape[3]
    sc = _scale(scale, D)
    qa, ka, va, doa = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    di = _di(do, o, dlse, acc)
    valid = _valid(T, mask, causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qa, ka) * sc
    p = torch.exp((s - lse.to(acc)[..., None]).masked_fill(
        ~valid, float("-inf")))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doa)
    dp = torch.einsum("bhqd,bhkd->bhqk", doa, va)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, ka) * sc
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qa) * sc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _di(do, o, dlse, acc):
    """D_i = rowsum(dO * o) - dlse, accumulated in `acc` (B, H, T); o is
    widened inside the product (the same values as widening it first, one
    pass over device memory fewer)."""
    di = (do.to(acc) * o).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.to(acc)
    return di


def flash_attention_reference(q, k, v, mask=None, causal=False, scale=None,
                              window=0):
    """Dense oracle with the same mask, window and GQA semantics, in
    differentiable torch ops."""
    D = q.shape[-1]
    k, v = _full_heads(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(scale, D)
    valid = _valid(q.shape[2], mask, causal, window, q.device)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~valid, 0.0)
    return torch.einsum("bhqk,bhkv->bhqv", p, v)


# ---------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """Forward through K3 (or its plain version), backward through K4/K5
    (or theirs), chosen by the device of q."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, window, bwd):
        fwd = helper_for("flash_attention_fwd", flash_fwd_plain, q)
        o, lse = fwd(q, k, v, mask, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.causal, ctx.scale = mask, causal, scale
        ctx.window, ctx.bwd = window, bwd
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        bwd = helper_for("flash_attention_bwd", flash_bwd_plain, q)
        dq, dk, dv = bwd(q, k, v, ctx.mask, o, lse, do, dlse, ctx.causal,
                         ctx.scale, ctx.window, ctx.bwd)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_lse(q, k, v, mask=None, causal: bool = False,
                        scale: Optional[float] = None, window: int = 0,
                        bwd: Optional[str] = None,
                        dq_partials: Optional[str] = None):
    """Like `flash_attention`, and also returns the per-row log-sum-exp
    (B, H, T) in float32 (float64 for float64 inputs); differentiable in
    both outputs."""
    _check_dq_partials(dq_partials)
    _check_shapes(q, k, v)
    return _FlashAttention.apply(q, k, v, mask, bool(causal), scale,
                                 int(window), _resolve_bwd(bwd))


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: Optional[float] = None, window: int = 0,
                    bwd: Optional[str] = None,
                    dq_partials: Optional[str] = None):
    """q/k/v (B, H, T, D), k/v possibly with Hk | H heads (forward only);
    mask an optional (B, T) key mask. Returns (B, H, T, D). `bwd`
    overrides the `configure()` default for this call."""
    return flash_attention_lse(q, k, v, mask, causal, scale, window, bwd,
                               dq_partials)[0]


# ------------------------------------------------------------------ kernels
def _route(dtype: torch.dtype, kind: str, D: int) -> str:
    """The source whose kernel takes a launch: `kind` "fwd" (K3), "fused"
    (K4) or "two_pass" (K5), D the kernel head dim. bf16 runs on the wgmma
    kernels of SM90_SOURCE up to SM90_MAX_D; fp32, and bf16 above
    (widened to fp32), on SOURCE."""
    if kind not in ("fwd",) + BWD_MODES:
        raise ValueError(f"unknown flash kernel kind {kind!r}")
    wide = D > HEAD_DIMS[-1] and D % WIDE_CHUNK == 0
    if D not in HEAD_DIMS and not wide:
        raise ValueError(f"no flash kernel at head dim {D} ({HEAD_DIMS}, "
                         f"then multiples of {WIDE_CHUNK})")
    return SM90_SOURCE if dtype == torch.bfloat16 and D in HEAD_DIMS \
        and D <= SM90_MAX_D else SOURCE


def _library(source: str):
    lib = build.load(source)
    if source == SM90_SOURCE:
        if lib.dl4j_flash_sm90_fwd.argtypes is None:
            # fwd: q, k, v, km, o, lse, 7 ints, scale, stream
            lib.dl4j_flash_sm90_fwd.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
            # bwd (K5) and bwd_fused (K4): q, k, v, km, do, lse, di, dq,
            # dk, dv, 6 ints, scale, stream
            for fn in (lib.dl4j_flash_sm90_bwd, lib.dl4j_flash_sm90_bwd_fused):
                fn.argtypes = [ctypes.c_void_p] * 10 + [
                    ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.dl4j_flash_sm90_fwd.restype = ctypes.c_int
            lib.dl4j_flash_sm90_smem.argtypes = [ctypes.c_int] * 2
            lib.dl4j_flash_sm90_smem.restype = ctypes.c_int
            lib.dl4j_flash_sm90_error_string.argtypes = [ctypes.c_int]
            lib.dl4j_flash_sm90_error_string.restype = ctypes.c_char_p
        return lib
    if lib.dl4j_flash_fwd.argtypes is None:
        # fwd: q, k, v, km, o, lse, 8 ints, scale, stream
        lib.dl4j_flash_fwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        # bwd: q, k, v, km, do, lse, di, dq, dk, dv, 8 ints, scale, stream
        lib.dl4j_flash_bwd.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.dl4j_flash_fwd.restype = ctypes.c_int
        lib.dl4j_flash_bwd.restype = ctypes.c_int
        lib.dl4j_flash_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(what, q, k, v, mask, *more):
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors only")
    _check_shapes(q, k, v)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {q.dtype} has no kernel on the card "
                        "(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v dtypes differ")
    tensors = [q, k, v] + [t for t in (mask,) + more if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all inputs must lie on one CUDA device")
    if mask is not None and tuple(mask.shape) != (q.shape[0], q.shape[2]):
        raise ValueError(f"{what}: mask must be (B, T) = "
                         f"{(q.shape[0], q.shape[2])}, got {tuple(mask.shape)}")


def _kernel_head_dim(D: int) -> int:
    """The smallest kernel head dim that holds D: one of HEAD_DIMS, or
    above them the next multiple of WIDE_CHUNK."""
    for d in HEAD_DIMS:
        if D <= d:
            return d
    return -(-D // WIDE_CHUNK) * WIDE_CHUNK


def _pad_d(t: torch.Tensor, Dp: int) -> torch.Tensor:
    return t if t.shape[-1] == Dp else torch.nn.functional.pad(
        t, (0, Dp - t.shape[-1]))


def padded_fwd(fwd, q, k, v, mask=None, causal=False, scale=None,
               window=0):
    """`fwd` (K3 or its plain version) with the head dim zero-padded to
    the kernels' next one, at the scale of the true D; returns (o, lse)
    at the true D."""
    D = q.shape[3]
    Dp = _kernel_head_dim(D)
    o, lse = fwd(_pad_d(q, Dp), _pad_d(k, Dp), _pad_d(v, Dp), mask, causal,
                 _scale(scale, D), window)
    return o[..., :D], lse


def padded_bwd(bwd, q, k, v, mask, o, lse, do, dlse=None, causal=False,
               scale=None, window=0, mode=None):
    """`bwd` (K4/K5 or their plain version) with the head dim zero-padded
    as in `padded_fwd`; returns (dq, dk, dv) at the true D."""
    D = q.shape[3]
    Dp = _kernel_head_dim(D)
    dq, dk, dv = bwd(*(_pad_d(t, Dp) for t in (q, k, v)), mask,
                     _pad_d(o, Dp), lse, _pad_d(do, Dp), dlse, causal,
                     _scale(scale, D), window, mode)
    return dq[..., :D], dk[..., :D], dv[..., :D]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous with a 16-byte-aligned start (the bf16 kernels copy
    rows 16 bytes at a time, and TMA takes 16-byte-aligned tensors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _key_mask(mask):
    return None if mask is None else (mask > 0).to(torch.int32).contiguous()


def _raise_on(error_string, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{error_string(err).decode()}")


def flash_attention_fwd_cuda(q, k, v, mask=None, causal: bool = False,
                             scale=None, window: int = 0):
    """K3 on CUDA tensors; same contract as `flash_fwd_plain`, any head
    dim. Launches on the current stream without a sync; counted
    in `.launches` and, per source, in `.route_launches`."""
    _check_cuda("flash_attention_fwd", q, k, v, mask)
    return padded_fwd(_fwd_launch, q, k, v, mask, causal, scale, window)


def _fwd_launch(q, k, v, mask, causal, scale, window):
    B, H, T, D = q.shape
    Hk = k.shape[1]
    dtype = q.dtype
    source = _route(dtype, "fwd", D)
    wide = source == SOURCE and dtype != torch.float32
    q, k, v = (_aligned(t.float() if wide else t) for t in (q, k, v))
    km = _key_mask(mask)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _library(source)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if km is None else km.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Hk, T, D, int(bool(causal)), int(window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if source == SM90_SOURCE:
        err = lib.dl4j_flash_sm90_fwd(*args, _scale(scale, D), stream)
        _raise_on(lib.dl4j_flash_sm90_error_string, err,
                  "flash_attention_fwd")
    else:
        err = lib.dl4j_flash_fwd(*args, _DTYPE_CODE[q.dtype],
                                 _scale(scale, D), stream)
        _raise_on(lib.dl4j_flash_error_string, err, "flash_attention_fwd")
    flash_attention_fwd_cuda.launches += 1
    flash_attention_fwd_cuda.route_launches[source] += 1
    return o.to(dtype), lse


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.route_launches = dict.fromkeys(SOURCES, 0)
register_helper("flash_attention_fwd")(flash_attention_fwd_cuda)


def flash_attention_bwd_cuda(q, k, v, mask, o, lse, do, dlse=None,
                             causal: bool = False, scale=None,
                             window: int = 0, bwd: Optional[str] = None):
    """K4 (bwd "fused": one kernel, dq added into an fp32 buffer, counted in
    `flash_attention_bwd_cuda.fused_launches`) or K5 (bwd "two_pass": the
    dq kernel and the dk/dv kernel, counted in `.two_pass_launches`, two
    per call) on CUDA tensors; same contract as `flash_bwd_plain`, any
    head dim. D_i is a torch reduction here, before the launch.
    Calls are also counted per source in `.route_launches`."""
    bwd = _resolve_bwd(bwd)
    _check_cuda("flash_attention_bwd", q, k, v, mask, o, lse, do)
    _no_grouped_backward(q, k)
    return padded_bwd(_bwd_launch, q, k, v, mask, o, lse, do, dlse, causal,
                      scale, window, bwd)


def _bwd_launch(q, k, v, mask, o, lse, do, dlse, causal, scale, window,
                bwd):
    B, H, T, D = q.shape
    dtype = q.dtype
    source = _route(dtype, bwd, D)
    wide = source == SOURCE and dtype != torch.float32
    q, k, v = (_aligned(t.float() if wide else t) for t in (q, k, v))
    do = _aligned(do.to(q.dtype))
    lse = lse.to(torch.float32).contiguous()
    di = _di(do, o, dlse, torch.float32).contiguous()
    km = _key_mask(mask)
    dq = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library(source)
    mode = 0 if bwd == "fused" else 1
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if km is None else km.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, T, D, int(bool(causal)), int(window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if source == SM90_SOURCE:
        fn = lib.dl4j_flash_sm90_bwd_fused if mode == 0 \
            else lib.dl4j_flash_sm90_bwd
        err = fn(*args, _scale(scale, D), stream)
        _raise_on(lib.dl4j_flash_sm90_error_string, err,
                  f"flash_attention_bwd ({bwd})")
    else:
        err = lib.dl4j_flash_bwd(*args, _DTYPE_CODE[q.dtype], mode,
                                 _scale(scale, D), stream)
        _raise_on(lib.dl4j_flash_error_string, err,
                  f"flash_attention_bwd ({bwd})")
    if mode == 0:
        flash_attention_bwd_cuda.fused_launches += 1
    else:
        flash_attention_bwd_cuda.two_pass_launches += 2
    flash_attention_bwd_cuda.route_launches[source] += 1
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


flash_attention_bwd_cuda.fused_launches = 0
flash_attention_bwd_cuda.two_pass_launches = 0
flash_attention_bwd_cuda.route_launches = dict.fromkeys(SOURCES, 0)
register_helper("flash_attention_bwd")(flash_attention_bwd_cuda)
