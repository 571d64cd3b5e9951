"""Threshold encoding of gradient updates (counterpart of the threshold
section of ops/pallas_kernels.py): Strom-style 1-bit compression with a
residual, the native "THRESHOLD" compressor of the reference's
EncodedGradientsAccumulator / EncodingHandler.

K11 maps (update, residual, threshold) to (message, new_residual) on
tensors of one shape and dtype, elementwise:

    acc = update + residual                    (in the update's dtype)
    message = sign(acc) * t where |acc| >= t, else 0
    new_residual = acc - message               (in the update's dtype)

with t the threshold rounded to the update's dtype, as the JAX package's
weakly typed Python float is (fp32 1e-3 is 0.0010000000474974513; bf16
rounds further). So a message holds exactly {-t, 0, +t}; NaN is never sent
and stays in the residual; +-inf is sent as +-t and stays +-inf; -0.0
sends +0.0. bf16 is not widened: acc rounds to bf16 before the comparison.

Kernel (`csrc/threshold_encode.cu`, CUDA C++ for sm_90a; fp32, bf16 and
fp64): `threshold_encode_list_cuda` replaces `threshold_encode_pallas`
(:325, body `_make_threshold_kernel` :313, call :338). One launch encodes a
list of tensors (a data-parallel step's parameter tensors), each of any
shape as its flat view (the Pallas kernel takes 1-D only); t is a run-time
argument (the Pallas kernel compiles one kernel per threshold). The
messages of a call share one allocation and the new residuals another,
handed back as views in each tensor's shape, each placed at the same
offset from 16 bytes as its update so that the kernel's 16-byte path runs
wherever the update and residual allow it; the caller's residual is not
written. Empty tensors launch nothing; `threshold_encode_cuda` is the
one-tensor case. The wrapper counts its launches in `.launches`.
`parallel/accumulation.threshold_encode_list` dispatches through
`ops/helpers.helper_for`: a CUDA tensor launches the kernel, a CPU tensor
runs `threshold_encode_plain` on each tensor.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import register_helper

SOURCE = "threshold_encode.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2, torch.float64: 3}


@functools.lru_cache(maxsize=64)
def threshold_in(threshold: float, dtype: torch.dtype) -> float:
    """The threshold rounded to `dtype`, as a Python float (exact)."""
    return torch.tensor(float(threshold), dtype=torch.float64).to(
        dtype).item()


def threshold_encode_plain(update, residual, threshold: float):
    """The plain version of K11: (message, new_residual) in the update's
    dtype."""
    acc = update + residual
    t = threshold_in(threshold, acc.dtype)
    msg = torch.where(acc.abs() >= t, torch.sign(acc) * t, 0.0)
    return msg, acc - msg


def threshold_encode_list_plain(updates, residuals, threshold: float):
    """The plain version of K11 over a list: ([message], [new_residual])."""
    out = [threshold_encode_plain(u, r, threshold)
           for u, r in zip(updates, residuals)]
    return [m for m, _ in out], [e for _, e in out]


# ------------------------------------------------------------------ kernel
class Entry(ctypes.Structure):
    """One tensor of the kernel's table (`HostEntry` in the source)."""
    _fields_ = [("update", ctypes.c_void_p), ("residual", ctypes.c_void_p),
                ("msg", ctypes.c_void_p), ("new_residual", ctypes.c_void_p),
                ("n", ctypes.c_longlong)]


def _library():
    lib = build.load(SOURCE)
    if lib.dl4j_threshold_encode.argtypes is None:
        # table, count, t, dtype, stream
        lib.dl4j_threshold_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p]
        lib.dl4j_threshold_encode.restype = ctypes.c_int
        lib.dl4j_threshold_encode_max_entries.argtypes = []
        lib.dl4j_threshold_encode_max_entries.restype = ctypes.c_int
        lib.dl4j_threshold_encode_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_threshold_encode_error_string.restype = ctypes.c_char_p
    return lib


def _check(updates, residuals):
    if len(updates) != len(residuals):
        raise ValueError(f"threshold_encode: {len(updates)} updates and "
                         f"{len(residuals)} residuals")
    dtype, device = updates[0].dtype, updates[0].device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"threshold_encode: dtype {dtype}: the card's kernel "
                        "takes float32, bfloat16 or float64")
    for u, r in zip(updates, residuals):
        if u.dtype != dtype or r.dtype != dtype:
            raise TypeError(f"threshold_encode: dtypes {u.dtype}, {r.dtype} "
                            f"beside {dtype}: one dtype for all")
        if r.shape != u.shape or u.device != device or r.device != device:
            raise ValueError(f"threshold_encode: residual {tuple(r.shape)} "
                             f"on {r.device} does not match update "
                             f"{tuple(u.shape)} on {u.device} (all on "
                             f"{device})")


def _layout(ptrs, sizes, elt):
    """Element offsets of the outputs in their flat allocation, each at
    its update's offset from 16 bytes, and the allocation's length."""
    per = 16 // elt
    offsets, end = [], 0
    for p, n in zip(ptrs, sizes):
        end += (p // elt - end) % per
        offsets.append(end)
        end += n
    return offsets, end


def _views(flat, offsets, sizes, end, updates):
    """The outputs of `updates` in `flat`: one split, then a view where a
    tensor is not 1-D."""
    cuts, at = [], 0
    for o, n in zip(offsets, sizes):
        cuts += [o - at, n]
        at = o + n
    parts = flat.split_with_sizes(cuts + [end - at])[1:-1:2]
    return [p if u.dim() == 1 else p.view(u.shape)
            for p, u in zip(parts, updates)]


def threshold_encode_list_cuda(updates, residuals, threshold: float):
    """K11 over lists of CUDA tensors, one launch (a list longer than the
    kernel's table takes one a table); the pairs may differ in shape, all
    share one dtype (float32, bfloat16 or float64) and device. Same
    contract as `threshold_encode_list_plain`. Launches on the current
    stream without a sync; counted in `.launches`."""
    updates, residuals = list(updates), list(residuals)
    if updates and updates[0].device.type != "cuda":
        raise ValueError("threshold_encode runs on CUDA tensors only")
    return _list_launch(updates, residuals, threshold)


def _list_launch(updates, residuals, threshold):
    if not updates and not residuals:
        return [], []
    _check(updates, residuals)
    u0 = updates[0]
    t = threshold_in(threshold, u0.dtype)
    if not t > 0.0:
        raise ValueError(f"threshold_encode: threshold {threshold} is "
                         f"{t} in {u0.dtype}; the kernel takes t > 0")
    updates = [u.contiguous() for u in updates]
    residuals = [r.contiguous() for r in residuals]
    elt = u0.element_size()
    ups = [u.data_ptr() for u in updates]
    sizes = [u.numel() for u in updates]
    offsets, end = _layout(ups, sizes, elt)
    flat = [torch.empty(end, dtype=u0.dtype, device=u0.device)
            for _ in range(2)]
    bases = [f.data_ptr() for f in flat]
    words = []
    for up, r, o, n in zip(ups, residuals, offsets, sizes):
        if n:
            words += [up, r.data_ptr(), bases[0] + o * elt,
                      bases[1] + o * elt, n]
    msgs, new_res = (_views(f, offsets, sizes, end, updates) for f in flat)
    count = len(words) // 5
    if not count:
        return msgs, new_res
    table = (Entry * count).from_buffer(array.array("Q", words))
    lib = _library()
    err = lib.dl4j_threshold_encode(
        table, count, t, _DTYPE_CODE[u0.dtype],
        torch.cuda.current_stream(u0.device).cuda_stream)
    if err != 0:
        why = lib.dl4j_threshold_encode_error_string(err).decode()
        raise RuntimeError(f"threshold_encode launch failed: {why}")
    per = lib.dl4j_threshold_encode_max_entries()
    threshold_encode_list_cuda.launches += -(-count // per)
    return msgs, new_res


def threshold_encode_cuda(update, residual, threshold: float):
    """K11 on one pair of CUDA tensors: the one-entry list."""
    msgs, new_res = threshold_encode_list_cuda([update], [residual],
                                               threshold)
    return msgs[0], new_res[0]


threshold_encode_list_cuda.launches = 0
register_helper("threshold_encode")(threshold_encode_list_cuda)
