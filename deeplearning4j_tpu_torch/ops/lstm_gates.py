"""The per-step LSTM cells (counterpart of the LSTM half of
ops/pallas_kernels.py): the gate nonlinearity and cell update between the
recurrent products of a masked LSTM step.

- `lstm_gates(gates, c) -> (c_new, h_new)`: the plain LSTM cell (K9);
- `graves_gates(gates, c, pi, pf, po) -> (c_new, h_new)`: the Graves
  (peephole) cell (K8).

`gates` (B, 4H) are the pre-activations in the order [i|f|o|g] (x W + b +
h RW, no peephole terms), c (B, H) the previous cell state, pi/pf/po (H,)
the peephole weights. Sub-fp32 inputs compute in fp32 and round once at
the output, as the Pallas kernels do; c_new and h_new come out in c's
dtype. Each cell is one `torch.autograd.Function` whose forward and
backward go through `ops/helpers.helper_for`: a CUDA tensor launches the
kernel, a CPU tensor runs the plain version. The backward recomputes the
activations from (gates, c) and applies the closed forms of the JAX
package's `_lstm_gates_bwd_kernel` (:51) and `_graves_gates_bwd_kernel`
(:184); the peephole gradients are sums over the batch, in fp32.

Kernels (`csrc/lstm_gates.cu`, CUDA C++ for sm_90a, fp32 and bf16):
- K9 `lstm_gates_cuda` / `lstm_gates_bwd_cuda` replace
  `lstm_gates_pallas` (:93);
- K8 `graves_gates_cuda` / `graves_gates_bwd_cuda` replace
  `graves_gates_pallas` (:226). K8's backward writes per-block fp32
  partials of dpi/dpf/dpo that a torch sum reduces here.
Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import helper_for, register_helper

SOURCE = "lstm_gates.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _split(g: torch.Tensor, H: int):
    return g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]


# ------------------------------------------------------------ plain versions
def lstm_gates_plain(gates, c):
    """The plain version of K9's forward: (c_new, h_new) in c's dtype."""
    acc = _acc(gates.dtype)
    zi, zf, zo, zg = _split(gates.to(acc), c.shape[-1])
    ca = c.to(acc)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g = torch.tanh(zg)
    c_new = f * ca + i * g
    return c_new.to(c.dtype), (o * torch.tanh(c_new)).to(c.dtype)


def lstm_gates_bwd_plain(gates, c, dc_new, dh):
    """The plain version of K9's backward: (dgates in gates' dtype, dc_prev
    in c's dtype)."""
    acc = _acc(gates.dtype)
    zi, zf, zo, zg = _split(gates.to(acc), c.shape[-1])
    ca, dca, dha = c.to(acc), dc_new.to(acc), dh.to(acc)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g = torch.tanh(zg)
    c_new = f * ca + i * g
    t = torch.tanh(c_new)
    dct = dca + dha * o * (1 - t * t)
    dgates = torch.cat([dct * g * i * (1 - i), dct * ca * f * (1 - f),
                        dha * t * o * (1 - o), dct * i * (1 - g * g)], dim=-1)
    return dgates.to(gates.dtype), (dct * f).to(c.dtype)


def graves_gates_plain(gates, c, pi, pf, po):
    """The plain version of K8's forward: (c_new, h_new) in c's dtype."""
    acc = _acc(gates.dtype)
    zi, zf, zo, zg = _split(gates.to(acc), c.shape[-1])
    ca = c.to(acc)
    i = torch.sigmoid(zi + ca * pi.to(acc))
    f = torch.sigmoid(zf + ca * pf.to(acc))
    g = torch.tanh(zg)
    c_new = f * ca + i * g
    o = torch.sigmoid(zo + c_new * po.to(acc))
    return c_new.to(c.dtype), (o * torch.tanh(c_new)).to(c.dtype)


def graves_gates_bwd_plain(gates, c, pi, pf, po, dc_new, dh):
    """The plain version of K8's backward: (dgates, dc_prev, dpi, dpf,
    dpo); the peephole gradients are batch sums in fp32, returned in the
    peepholes' dtype."""
    acc = _acc(gates.dtype)
    zi, zf, zo, zg = _split(gates.to(acc), c.shape[-1])
    ca, dca, dha = c.to(acc), dc_new.to(acc), dh.to(acc)
    pia, pfa, poa = pi.to(acc), pf.to(acc), po.to(acc)
    i = torch.sigmoid(zi + ca * pia)
    f = torch.sigmoid(zf + ca * pfa)
    g = torch.tanh(zg)
    c_new = f * ca + i * g
    o = torch.sigmoid(zo + c_new * poa)
    t = torch.tanh(c_new)
    dzo = dha * t * o * (1 - o)
    dct = dca + dha * o * (1 - t * t) + dzo * poa
    dzi = dct * g * i * (1 - i)
    dzf = dct * ca * f * (1 - f)
    dzg = dct * i * (1 - g * g)
    dgates = torch.cat([dzi, dzf, dzo, dzg], dim=-1).to(gates.dtype)
    dc_prev = (dct * f + dzi * pia + dzf * pfa).to(c.dtype)
    return (dgates, dc_prev, (dzi * ca).sum(0).to(pi.dtype),
            (dzf * ca).sum(0).to(pf.dtype), (dzo * c_new).sum(0).to(po.dtype))


# ---------------------------------------------------------------- autograd
class _LstmGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates, c):
        ctx.save_for_backward(gates, c)
        return helper_for("lstm_gates_fwd", lstm_gates_plain, gates)(gates, c)

    @staticmethod
    def backward(ctx, dc_new, dh):
        gates, c = ctx.saved_tensors
        bwd = helper_for("lstm_gates_bwd", lstm_gates_bwd_plain, gates)
        return bwd(gates, c, dc_new, dh)


class _GravesGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates, c, pi, pf, po):
        ctx.save_for_backward(gates, c, pi, pf, po)
        fwd = helper_for("graves_gates_fwd", graves_gates_plain, gates)
        return fwd(gates, c, pi, pf, po)

    @staticmethod
    def backward(ctx, dc_new, dh):
        gates, c, pi, pf, po = ctx.saved_tensors
        bwd = helper_for("graves_gates_bwd", graves_gates_bwd_plain, gates)
        return bwd(gates, c, pi, pf, po, dc_new, dh)


def lstm_gates(gates, c):
    """(c_new, h_new) of the plain LSTM cell; differentiable."""
    return _LstmGates.apply(gates, c)


def graves_gates(gates, c, pi, pf, po):
    """(c_new, h_new) of the Graves peephole cell; differentiable."""
    return _GravesGates.apply(gates, c, pi, pf, po)


# ------------------------------------------------------------------ kernels
def _library():
    lib = build.load(SOURCE)
    if lib.dl4j_lstm_gates_fwd.argtypes is None:
        # fwd: gates, c, pi, pf, po, c_new, h_new, B, H, dtype, stream
        lib.dl4j_lstm_gates_fwd.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        # bwd: gates, c, pi, pf, po, dc, dh, dgates, dcprev, partials,
        #      B, H, dtype, stream
        lib.dl4j_lstm_gates_bwd.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.dl4j_lstm_gates_blocks.argtypes = [ctypes.c_int]
        for fn in (lib.dl4j_lstm_gates_fwd, lib.dl4j_lstm_gates_bwd,
                   lib.dl4j_lstm_gates_blocks):
            fn.restype = ctypes.c_int
        lib.dl4j_lstm_gates_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_gates_error_string.restype = ctypes.c_char_p
    return lib


def _check(what, gates, c, *more):
    if gates.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors only")
    if gates.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {gates.dtype} has no kernel on the "
                        "card (float32, bfloat16)")
    B, H = c.shape
    if tuple(gates.shape) != (B, 4 * H):
        raise ValueError(f"{what}: gates {tuple(gates.shape)} and c "
                         f"{tuple(c.shape)} do not match (B, 4H) / (B, H)")
    for t in (c,) + more:
        if t.dtype != gates.dtype or t.device != gates.device:
            raise TypeError(f"{what}: every input must share the gates' "
                            f"dtype {gates.dtype} and device")
    return B, H


def _launch(lib, fn, what, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.dl4j_lstm_gates_error_string(err).decode()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _gates_fwd_cuda(what, gates, c, peep):
    B, H = _check(what, gates, c, *peep)
    gates, c = gates.contiguous(), c.contiguous()
    peep = [p.contiguous() for p in peep]
    c_new, h_new = torch.empty_like(c), torch.empty_like(c)
    lib = _library()
    pi, pf, po = peep if peep else (None, None, None)
    _launch(lib, lib.dl4j_lstm_gates_fwd, what, gates.data_ptr(),
            c.data_ptr(), _ptr(pi), _ptr(pf), _ptr(po), c_new.data_ptr(),
            h_new.data_ptr(), B, H, _DTYPE_CODE[gates.dtype],
            torch.cuda.current_stream(gates.device).cuda_stream)
    return c_new, h_new


def _gates_bwd_cuda(what, gates, c, peep, dc_new, dh):
    B, H = _check(what, gates, c, *peep, dc_new, dh)
    gates, c = gates.contiguous(), c.contiguous()
    dc_new, dh = dc_new.contiguous(), dh.contiguous()
    peep = [p.contiguous() for p in peep]
    dgates, dc_prev = torch.empty_like(gates), torch.empty_like(c)
    lib = _library()
    partials = None
    if peep:
        partials = torch.empty((3, lib.dl4j_lstm_gates_blocks(B), H),
                               dtype=torch.float32, device=gates.device)
    pi, pf, po = peep if peep else (None, None, None)
    _launch(lib, lib.dl4j_lstm_gates_bwd, what, gates.data_ptr(),
            c.data_ptr(), _ptr(pi), _ptr(pf), _ptr(po), dc_new.data_ptr(),
            dh.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(),
            _ptr(partials), B, H, _DTYPE_CODE[gates.dtype],
            torch.cuda.current_stream(gates.device).cuda_stream)
    if not peep:
        return dgates, dc_prev
    dp = partials.sum(1)                      # (3, H) fp32, over the blocks
    return (dgates, dc_prev, dp[0].to(pi.dtype), dp[1].to(pf.dtype),
            dp[2].to(po.dtype))


def lstm_gates_cuda(gates, c):
    """K9 forward on CUDA tensors; same contract as `lstm_gates_plain`."""
    out = _gates_fwd_cuda("lstm_gates", gates, c, [])
    lstm_gates_cuda.launches += 1
    return out


def lstm_gates_bwd_cuda(gates, c, dc_new, dh):
    """K9 backward on CUDA tensors; same contract as
    `lstm_gates_bwd_plain`."""
    out = _gates_bwd_cuda("lstm_gates_bwd", gates, c, [], dc_new, dh)
    lstm_gates_bwd_cuda.launches += 1
    return out


def graves_gates_cuda(gates, c, pi, pf, po):
    """K8 forward on CUDA tensors; same contract as `graves_gates_plain`."""
    out = _gates_fwd_cuda("graves_gates", gates, c, [pi, pf, po])
    graves_gates_cuda.launches += 1
    return out


def graves_gates_bwd_cuda(gates, c, pi, pf, po, dc_new, dh):
    """K8 backward on CUDA tensors; same contract as
    `graves_gates_bwd_plain`."""
    out = _gates_bwd_cuda("graves_gates_bwd", gates, c, [pi, pf, po],
                          dc_new, dh)
    graves_gates_bwd_cuda.launches += 1
    return out


for _fn in (lstm_gates_cuda, lstm_gates_bwd_cuda, graves_gates_cuda,
            graves_gates_bwd_cuda):
    _fn.launches = 0
register_helper("lstm_gates_fwd")(lstm_gates_cuda)
register_helper("lstm_gates_bwd")(lstm_gates_bwd_cuda)
register_helper("graves_gates_fwd")(graves_gates_cuda)
register_helper("graves_gates_bwd")(graves_gates_bwd_cuda)
