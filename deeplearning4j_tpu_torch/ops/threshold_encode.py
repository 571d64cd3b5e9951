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
fp64): `threshold_encode_cuda` replaces `threshold_encode_pallas` (:325,
body `_make_threshold_kernel` :313, call :338). t is a run-time argument
(the Pallas kernel compiles one kernel per threshold). The function is
elementwise, so the kernel takes any shape as its flat view (the Pallas
kernel takes 1-D only); n = 0 launches nothing. The wrapper counts its
launches in `.launches`. `parallel/accumulation.threshold_encode`
dispatches through `ops/helpers.helper_for`: a CUDA tensor launches the
kernel, a CPU tensor runs `threshold_encode_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import register_helper

SOURCE = "threshold_encode.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2, torch.float64: 3}


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


# ------------------------------------------------------------------ kernel
def _library():
    lib = build.load(SOURCE)
    if lib.dl4j_threshold_encode.argtypes is None:
        # update, residual, msg, new_residual, n, t, dtype, stream
        lib.dl4j_threshold_encode.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p]
        lib.dl4j_threshold_encode.restype = ctypes.c_int
        lib.dl4j_threshold_encode_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_threshold_encode_error_string.restype = ctypes.c_char_p
    return lib


def threshold_encode_cuda(update, residual, threshold: float):
    """K11 on CUDA tensors of one shape and dtype (float32, bfloat16 or
    float64); same contract as `threshold_encode_plain`. Launches on the
    current stream without a sync; counted in `.launches`."""
    if update.device.type != "cuda":
        raise ValueError("threshold_encode runs on CUDA tensors only")
    if update.dtype not in _DTYPE_CODE or residual.dtype != update.dtype:
        raise TypeError(f"threshold_encode: dtypes {update.dtype}, "
                        f"{residual.dtype}: the card's kernel takes float32, "
                        "bfloat16 or float64, the same for both")
    if residual.shape != update.shape or residual.device != update.device:
        raise ValueError(f"threshold_encode: residual {tuple(residual.shape)}"
                         f" on {residual.device} does not match update "
                         f"{tuple(update.shape)} on {update.device}")
    t = threshold_in(threshold, update.dtype)
    if not t > 0.0:
        raise ValueError(f"threshold_encode: threshold {threshold} is "
                         f"{t} in {update.dtype}; the kernel takes t > 0")
    update, residual = update.contiguous(), residual.contiguous()
    msg, new_res = torch.empty_like(update), torch.empty_like(update)
    n = update.numel()
    if n == 0:
        return msg, new_res
    lib = _library()
    err = lib.dl4j_threshold_encode(
        update.data_ptr(), residual.data_ptr(), msg.data_ptr(),
        new_res.data_ptr(), n, t, _DTYPE_CODE[update.dtype],
        torch.cuda.current_stream(update.device).cuda_stream)
    if err != 0:
        why = lib.dl4j_threshold_encode_error_string(err).decode()
        raise RuntimeError(f"threshold_encode launch failed: {why}")
    threshold_encode_cuda.launches += 1
    return msg, new_res


threshold_encode_cuda.launches = 0
register_helper("threshold_encode")(threshold_encode_cuda)
