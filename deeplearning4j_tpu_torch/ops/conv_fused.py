"""The fused 1x1 convolution + training-mode BatchNorm (+ ReLU)
(counterpart of ops/conv_fused.py): two thirds of ResNet50's bottleneck
convolutions are 1x1 and feed a BatchNormalization, and
`ComputationGraph` runs every such pair through `conv1x1_bn_act` in
training.

- `conv1x1_stats(x3, w) -> (y, sum_y, sum_y2)`: x3 (B, C_in, P), w
  (C_out, C_in); y = W x3 (B, C_out, P) in x3's dtype, and the
  per-channel sums of y and y^2 over B and P, taken before y is rounded,
  in one width above the input (fp32 for bf16/fp16, fp64 for fp32 and
  fp64), the JAX package's rule under x64.
- `conv1x1_bn_act(x, w, gamma, beta, bias, eps, relu, stride) -> (out,
  mean, var)`: x (B, C_in, H, W) NCHW, the stride-s 1x1 convolution as
  the strided slice x[:, :, ::s, ::s] (taken here in torch, as the JAX
  package does), the batch statistics from the sums, the normalize pass
  and the optional ReLU in torch; mean and var are the batch statistics
  in the accumulator dtype. A `torch.autograd.Function`: the backward is
  the JAX package's analytic one (`_conv1x1_bn_act_bwd` :169-221) in
  torch, y recomputed from x (y is not saved), cotangents on mean and var
  included. Its products are `torch.matmul`, as they are plain XLA in the
  reference; one difference: torch has no bf16 product with an fp32
  result, so in bf16 the recomputed y is rounded to bf16 before xhat.
- `conv1x1_bn_act_plain`: the unfused oracle (`conv1x1_bn_act_xla`
  :225): a library convolution, one-pass fp32 statistics for sub-fp32
  inputs and two-pass for fp32/fp64, normalize, ReLU.

Kernel (`csrc/conv1x1_stats.cu`, CUDA C++ for sm_90a, fp32 and bf16):
`conv1x1_stats_cuda` replaces `conv1x1_stats_pallas` (:68, call :88). It
writes per-tile partial sums that a torch sum reduces here, and counts
its launches in `.launches`. The bf16 kernel (wgmma, a ring of TMA or
cp.async loads) loads x by one of five paths that `conv1x1_load_path`
picks from P and the channels before the launch (a TMA map of x needs P % 8 ==
0); each
path counts its launches in `.path_launches`. `conv1x1_stats` goes
through `ops/helpers.helper_for`: a CUDA tensor launches the kernel, a
CPU tensor runs `conv1x1_stats_plain`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import helper_for, register_helper

SOURCE = "conv1x1_stats.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
# the bf16 kernel's ways of loading x, by their codes in the source
LOAD_PATHS = ("tma_image", "tma_images", "cp_async", "ld_st", "bulk")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The statistics' dtype: one width above the activations."""
    return torch.float32 if dtype.itemsize < 4 else torch.float64


# ------------------------------------------------------------ plain versions
def conv1x1_stats_plain(x3, w):
    """The plain version of K10: the product in the accumulator dtype, then
    the two sums; y rounds to x3's dtype."""
    acc = _acc(x3.dtype)
    y = torch.matmul(w.to(acc), x3.to(acc))              # (B, C_out, P)
    return y.to(x3.dtype), y.sum(dim=(0, 2)), (y * y).sum(dim=(0, 2))


def conv1x1_stats(x3, w):
    """(y, sum_y, sum_y2) of x3 (B, C_in, P) and w (C_out, C_in): K10 on
    the card, the plain version on the CPU."""
    return helper_for("conv1x1_stats", conv1x1_stats_plain, x3)(x3, w)


def conv1x1_bn_act_plain(x, w, gamma, beta, bias, eps: float, relu: bool,
                         stride: int):
    """The unfused composition: convolution, batch statistics (one-pass in
    fp32 for sub-fp32 inputs, two-pass otherwise), normalize, ReLU.
    Returns (out in x's dtype, mean, var)."""
    if stride != 1:
        x = x[:, :, ::stride, ::stride]
    y = F.conv2d(x, w[:, :, None, None]) + bias[None, :, None, None]
    if x.dtype.itemsize < 4:
        yf = y.float()
        mean = yf.mean(dim=(0, 2, 3))
        var = torch.clamp((yf * yf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
    else:
        yf = y
        mean = yf.mean(dim=(0, 2, 3))
        var = yf.var(dim=(0, 2, 3), correction=0)
    pdt = yf.dtype
    out = (yf - mean[None, :, None, None]) \
        * torch.rsqrt(var + eps)[None, :, None, None] \
        * gamma.to(pdt)[None, :, None, None] \
        + beta.to(pdt)[None, :, None, None]
    if relu:
        out = torch.maximum(out, out.new_tensor(0.0))
    return out.to(x.dtype), mean, var


# ---------------------------------------------------------------- autograd
def _strided(x, stride):
    return x[:, :, ::stride, ::stride] if stride != 1 else x


class _Conv1x1BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, bias, eps, relu, stride):
        xs = _strided(x, stride)
        B, C_in, H, W = xs.shape
        y3, s1, s2 = conv1x1_stats(xs.reshape(B, C_in, H * W), w)
        n = B * H * W
        acc = s1.dtype
        m0 = s1 / n                          # the mean of y without bias
        mean = m0 + bias.to(acc)
        var = torch.clamp(s2 / n - m0 * m0, min=0.0)  # bias cancels
        scale = gamma.to(acc) * torch.rsqrt(var + eps)
        shift = beta.to(acc) - (mean - bias.to(acc)) * scale
        out = y3.to(acc) * scale[None, :, None] + shift[None, :, None]
        if relu:
            out = torch.maximum(out, out.new_tensor(0.0))
        out = out.to(x.dtype).reshape(B, -1, H, W)
        ctx.save_for_backward(x, w, gamma, beta, bias, mean, var, out)
        ctx.eps, ctx.relu, ctx.stride = eps, relu, stride
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        x, w, gamma, beta, bias, mean, var, out = ctx.saved_tensors
        stride = ctx.stride
        xs = _strided(x, stride)
        B, C_in, H, W = xs.shape
        P = H * W
        n = B * P
        f32 = torch.promote_types(x.dtype, torch.float32)
        x3 = xs.reshape(B, C_in, P)
        invstd = torch.rsqrt(var + ctx.eps)[None, :, None]
        yb = torch.matmul(w, x3).to(f32) + bias.to(f32)[None, :, None]
        centred = yb - mean[None, :, None]
        xhat = centred * invstd
        if g_out is None:
            g = torch.zeros_like(xhat)
        else:
            g = g_out.to(f32).reshape(B, -1, P)
            if ctx.relu:
                g = g * (out.reshape(B, -1, P) > 0)
        dgamma = (g * xhat).sum(dim=(0, 2))
        dbeta = g.sum(dim=(0, 2))
        dxhat = g * gamma.to(f32)[None, :, None]
        dy = (dxhat - dxhat.mean(dim=(0, 2), keepdim=True)
              - xhat * (dxhat * xhat).mean(dim=(0, 2), keepdim=True)) \
            * invstd
        if g_mean is not None:
            dy = dy + (g_mean.to(f32) / n)[None, :, None]
        if g_var is not None:
            dy = dy + (g_var.to(f32) * 2.0 / n)[None, :, None] * centred
        dbias = dy.sum(dim=(0, 2))
        dyl = dy.to(x.dtype)
        dw = torch.einsum("bop,bip->oi", dyl, x3)
        dxs = torch.matmul(w.t(), dyl).reshape(B, C_in, H, W)
        if stride != 1:
            dx = torch.zeros_like(x)
            dx[:, :, ::stride, ::stride] = dxs.to(x.dtype)
        else:
            dx = dxs
        return (dx.to(x.dtype), dw.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), dbias.to(bias.dtype), None, None,
                None)


def conv1x1_bn_act(x, w, gamma, beta, bias, eps: float, relu: bool,
                   stride: int):
    """The fused 1x1 conv (+ bias) + training BatchNorm (+ ReLU); see the
    module docstring. Returns (out, mean, var)."""
    return _Conv1x1BnAct.apply(x, w, gamma, beta, bias, float(eps),
                               bool(relu), int(stride))


# ------------------------------------------------------------------ kernel
def conv1x1_load_path(P: int, C_in: int, C_out: int) -> str:
    """How the bf16 kernel loads x (B, C_in, P), whose rows are 2 P bytes
    apart: by TMA where that is 16-aligned, 128 positions of one image a
    tile for P > 64 ("tma_image", P 784) or 128 / P whole images for P 16,
    32 or 64 ("tma_images", P 16); else by cp.async of 16, 8 or 4 bytes
    for even P ("cp_async", P 196). At odd P a row is 2-byte aligned only,
    but the rows of one image are one run, 16-byte aligned in x when C_in
    % 8 == 0 and in y when C_out % 8 == 0: "bulk" (P 49, 1; P <= 128)
    takes 128 / P whole images a tile, copies x's runs by the TMA unit and
    converts them in shared memory, and writes y's runs 16 bytes at a
    time; the rest take 2-byte loads and stores ("ld_st")."""
    if P % 8 == 0 and P > 64:
        return "tma_image"
    if P in (16, 32, 64):
        return "tma_images"
    if P % 2 == 0:
        return "cp_async"
    bulk = P <= 128 and C_in % 8 == 0 and C_out % 8 == 0
    return "bulk" if bulk else "ld_st"


def _library():
    lib = build.load(SOURCE)
    if lib.dl4j_conv1x1_stats.argtypes is None:
        # x, w, y, partials, B, C_in, ldw, C_out, P, dtype, path, stream
        lib.dl4j_conv1x1_stats.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.dl4j_conv1x1_stats.restype = ctypes.c_int
        lib.dl4j_conv1x1_tiles.argtypes = [ctypes.c_int] * 6
        lib.dl4j_conv1x1_tiles.restype = ctypes.c_long
        lib.dl4j_conv1x1_smem.argtypes = [ctypes.c_int] * 2
        lib.dl4j_conv1x1_smem.restype = ctypes.c_int
        lib.dl4j_conv1x1_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_conv1x1_error_string.restype = ctypes.c_char_p
    return lib


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous with a 16-byte-aligned start (TMA, cp.async)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv1x1_stats_cuda(x3, w):
    """K10 on CUDA tensors; same contract as `conv1x1_stats_plain`.
    Launches on the current stream without a sync; counted in
    `.launches`."""
    if x3.device.type != "cuda":
        raise ValueError("conv1x1_stats runs on CUDA tensors only")
    return _conv1x1_launch(x3, w)


def _conv1x1_launch(x3, w):
    if x3.dtype not in _DTYPE_CODE or w.dtype != x3.dtype:
        raise TypeError(f"conv1x1_stats: dtypes {x3.dtype}, {w.dtype}: the "
                        "card's kernel takes float32 or bfloat16, the same "
                        "for x and w")
    B, C_in, P = x3.shape
    if w.dim() != 2 or w.shape[1] != C_in or w.device != x3.device:
        raise ValueError(f"conv1x1_stats: w {tuple(w.shape)} does not match "
                         f"x3 {tuple(x3.shape)} (need (C_out, C_in) on "
                         "x3's device)")
    C_out = w.shape[0]
    code = _DTYPE_CODE[x3.dtype]
    path, ldw = 0, C_in
    if x3.dtype == torch.bfloat16:
        # W by TMA: rows of ldw, a multiple of 8 (zero columns past C_in)
        path = LOAD_PATHS.index(conv1x1_load_path(P, C_in, C_out))
        ldw = -(-C_in // 8) * 8
        if ldw != C_in:
            w = torch.nn.functional.pad(w, (0, ldw - C_in))
    x3, w = _aligned16(x3), _aligned16(w)
    lib = _library()
    tiles = lib.dl4j_conv1x1_tiles(B, P, C_in, C_out, code, path)
    y = torch.empty((B, C_out, P), dtype=x3.dtype, device=x3.device)
    part = torch.empty((tiles, 2, C_out), dtype=_acc(x3.dtype),
                       device=x3.device)
    err = lib.dl4j_conv1x1_stats(
        x3.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), B, C_in,
        ldw, C_out, P, code, path,
        torch.cuda.current_stream(x3.device).cuda_stream)
    if err != 0:
        raise RuntimeError("conv1x1_stats launch failed: "
                           f"{lib.dl4j_conv1x1_error_string(err).decode()}")
    conv1x1_stats_cuda.launches += 1
    if x3.dtype == torch.bfloat16:
        conv1x1_stats_cuda.path_launches[LOAD_PATHS[path]] += 1
    s = part.sum(dim=0)                       # (2, C_out), over the tiles
    return y, s[0], s[1]


conv1x1_stats_cuda.launches = 0
conv1x1_stats_cuda.path_launches = dict.fromkeys(LOAD_PATHS, 0)
register_helper("conv1x1_stats")(conv1x1_stats_cuda)
