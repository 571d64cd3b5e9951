"""The whole-sequence Graves-LSTM scan (counterpart of
ops/lstm_scan_fused.py): every unmasked LSTM layer with sigmoid/tanh
activations, every tBPTT segment and every `rnn_time_step` runs its
recurrence through `graves_lstm_scan`.

`graves_lstm_scan(xw, rw, pi, pf, po, h0, c0) -> (ys, cs)` keeps the JAX
signature and layout: xw (T, B, 4H) is the input projection x W + b with
gate order [i|f|o|g], rw (H, 4H), pi/pf/po (H,) the peepholes (zeros for a
plain LSTM), h0/c0 (B, H); ys and cs (T, B, H) are every step's h and c.
It is differentiable in all seven inputs and takes a cotangent on cs as
well as on ys.

Rounding, as in the JAX kernel: the storage dtype is xw's; the gate math
runs in fp32 (fp64 for fp64 inputs); h and c round to the storage dtype
every step, and so do the carried dh and dc of the backward; the gate
gradients round before both products that use them (dh_prev = dgates
RW^T and dRW += h_prev^T dgates); dRW and the peephole gradients sum in
fp32 and are returned in the parameters' dtypes. The plain versions
(`graves_lstm_scan_plain`, `graves_lstm_scan_bwd_plain`, an explicit
reverse loop of the JAX `_scan_bwd` math, not autograd through the
forward loop) keep those rounding points, so in fp64 they equal the JAX
package's `graves_lstm_scan_xla` and in bf16 they are the kernel's own
reference.

Kernels (`csrc/lstm_scan.cu`, CUDA C++ for sm_90a, fp32 and bf16, H a
multiple of 16 up to what a 16-row tile's shared memory holds; the
wrappers zero-pad any other H to the next multiple of 16, per gate, and
cut the outputs back: a padded unit has zero weights, so its gates are
0.5, 0.5, 0.5 and tanh(0) = 0 and its h and c stay 0, and it adds
nothing to any gradient):
`graves_lstm_scan_fwd_cuda` replaces the forward of
`graves_lstm_scan_pallas` (:379, call :411), `graves_lstm_scan_bwd_cuda`
its backward (call :492): the reverse sweep, then a second kernel for dRW.
The per-CTA peephole partials are summed in torch. Each counts its calls
in `.launches`. Both directions have two variants, chosen by
`scan_fwd_variant(H, dtype)` and `scan_bwd_variant(H, dtype)` before the
launch: "cluster" (bf16 at a padded H of 64, 128 or 256, a cluster of 8
CTAs that keeps RW in shared memory and passes h, or the partial sums of
dh, between its CTAs through distributed shared memory; the char-RNN's
H 256: `csrc/lstm_scan_fwd_sm90.cu`, `csrc/lstm_scan_bwd_sm90.cu`) and
"tile" (`lstm_scan.cu`: every other H, and fp32); each counts its
launches in `.variant_launches` of its wrapper. In bf16, dRW of either
sweep is the wgmma kernel of `lstm_scan_bwd_sm90.cu`: each (output tile,
row chunk) writes an fp32 partial, and `reduce_drw_partials` sums the
chunks in order, so dRW repeats bit for bit; fp32 keeps `lstm_scan.cu`'s
split-K kernel, whose chunks meet through atomics.

`configure(gate_math=...)`: "fp32" is the only mode; "native" (bf16 gate
math) raises NotImplementedError (ROADMAP queue 2). `grid` and `k_steps`
choose the TPU kernel's grid layout and time-step blocking and have no
counterpart on the card: they raise. No DL4J_TPU_LSTM_* variable is read.
`scan_fits(H, dtype, device)` is the shape rule the layers read before
they call the scan, the counterpart of the JAX package's `fits_vmem`:
where even a 16-row tile of the padded H does not fit in shared memory,
the layer steps through the gate kernels (K8/K9) instead. The kernels
themselves never fall back: they raise on a shape they do not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.helpers import helper_for, register_helper

SOURCE = "lstm_scan.cu"
SM90_SOURCE = "lstm_scan_fwd_sm90.cu"
BWD_SM90_SOURCE = "lstm_scan_bwd_sm90.cu"
SOURCES = (SOURCE, SM90_SOURCE, BWD_SM90_SOURCE)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
# H (padded) of the cluster forward: H / 8 units per CTA, a multiple of 8,
# and its RW slice (8 H^2 / 8 bytes) with the h buffers in shared memory
CLUSTER_FWD_H = (64, 128, 256)
CLUSTER_ROWS = 128          # batch rows of a cluster
FWD_VARIANTS = ("cluster", "tile")
BWD_VARIANTS = FWD_VARIANTS


def configure(gate_math: Optional[str] = None, grid=None, k_steps=None):
    """The JAX package's dispatch knobs. Returns the previous settings as
    a dict; only gate_math="fp32" is accepted."""
    if grid is not None or k_steps is not None:
        raise NotImplementedError(
            "grid and k_steps choose the TPU kernel's grid layout and time "
            "blocking; the CUDA scan has no counterpart (one CTA per batch "
            "tile loops over all T)")
    if gate_math not in (None, "fp32"):
        raise NotImplementedError(
            f"gate_math={gate_math!r}: the port computes the LSTM gates in "
            "fp32 only; 'native' (gate math in the storage dtype) waits in "
            "ROADMAP.md queue 2 (K7)")
    return {"gate_math": "fp32"}


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _cell(gates, c, pi, pf, po, H):
    """(i, f, g, c_new, o) of the Graves cell, all in gates' dtype."""
    i = torch.sigmoid(gates[:, :H] + c * pi)
    f = torch.sigmoid(gates[:, H:2 * H] + c * pf)
    g = torch.tanh(gates[:, 3 * H:])
    c_new = f * c + i * g
    o = torch.sigmoid(gates[:, 2 * H:3 * H] + c_new * po)
    return i, f, g, c_new, o


# ------------------------------------------------------------ plain versions
def graves_lstm_scan_plain(xw, rw, pi, pf, po, h0, c0):
    """The plain version of K7's forward: a loop over T with the kernel's
    rounding points. Returns (ys, cs) in xw's dtype."""
    dt, acc = xw.dtype, _acc(xw.dtype)
    H = rw.shape[0]
    rwa = rw.to(acc)
    pia, pfa, poa = pi.to(acc), pf.to(acc), po.to(acc)
    h, c = h0.to(dt), c0.to(dt)
    ys, cs = [], []
    for t in range(xw.shape[0]):
        gates = xw[t].to(acc) + h.to(acc) @ rwa
        _, _, _, c_new, o = _cell(gates, c.to(acc), pia, pfa, poa, H)
        h, c = (o * torch.tanh(c_new)).to(dt), c_new.to(dt)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


def graves_lstm_scan_bwd_plain(xw, rw, pi, pf, po, h0, c0, ys, cs, dys,
                               dcs):
    """The plain version of K7's backward: an explicit reverse loop of the
    JAX `_scan_bwd` math. Returns (dxw, drw, dpi, dpf, dpo, dh0, dc0): dxw,
    dh0, dc0 in xw's dtype, the rest in their parameters' dtypes."""
    dt, acc = xw.dtype, _acc(xw.dtype)
    T, B = xw.shape[0], xw.shape[1]
    H = rw.shape[0]
    rwa = rw.to(acc)
    pia, pfa, poa = pi.to(acc), pf.to(acc), po.to(acc)
    dh_c = torch.zeros((B, H), dtype=dt, device=xw.device)
    dc_c = torch.zeros((B, H), dtype=dt, device=xw.device)
    drw = torch.zeros((H, 4 * H), dtype=acc, device=xw.device)
    dp = torch.zeros((3, H), dtype=acc, device=xw.device)
    dxw = torch.empty_like(xw)
    for t in range(T - 1, -1, -1):
        h_prev = (ys[t - 1] if t > 0 else h0).to(dt)
        c_prev = (cs[t - 1] if t > 0 else c0).to(dt).to(acc)
        gates = xw[t].to(acc) + h_prev.to(acc) @ rwa
        i, f, g, c_new, o = _cell(gates, c_prev, pia, pfa, poa, H)
        t_new = torch.tanh(c_new)
        dh = dys[t].to(acc) + dh_c.to(acc)
        dc_in = dc_c.to(acc) + dcs[t].to(acc)
        dzo = dh * t_new * o * (1 - o)
        dct = dc_in + dh * o * (1 - t_new * t_new) + dzo * poa
        dzi = dct * g * i * (1 - i)
        dzf = dct * c_prev * f * (1 - f)
        dzg = dct * i * (1 - g * g)
        dgl = torch.cat([dzi, dzf, dzo, dzg], dim=-1).to(dt)
        dxw[t] = dgl
        dh_c = (dgl.to(acc) @ rwa.t()).to(dt)
        dc_c = (dct * f + dzi * pia + dzf * pfa).to(dt)
        drw += h_prev.to(acc).t() @ dgl.to(acc)
        dp[0] += (dzi * c_prev).sum(0)
        dp[1] += (dzf * c_prev).sum(0)
        dp[2] += (dzo * c_new).sum(0)
    return (dxw, drw.to(rw.dtype), dp[0].to(pi.dtype), dp[1].to(pf.dtype),
            dp[2].to(po.dtype), dh_c, dc_c)


# ---------------------------------------------------------------- autograd
class _GravesLstmScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, rw, pi, pf, po, h0, c0):
        fwd = helper_for("graves_lstm_scan_fwd", graves_lstm_scan_plain, xw)
        ys, cs = fwd(xw, rw, pi, pf, po, h0, c0)
        ctx.save_for_backward(xw, rw, pi, pf, po, h0, c0, ys, cs)
        ctx.set_materialize_grads(False)
        return ys, cs

    @staticmethod
    def backward(ctx, dys, dcs):
        xw, rw, pi, pf, po, h0, c0, ys, cs = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys
        dcs = torch.zeros_like(cs) if dcs is None else dcs
        bwd = helper_for("graves_lstm_scan_bwd", graves_lstm_scan_bwd_plain,
                         xw)
        dxw, drw, dpi, dpf, dpo, dh0, dc0 = bwd(xw, rw, pi, pf, po, h0, c0,
                                                ys, cs, dys, dcs)
        return (dxw, drw, dpi, dpf, dpo, dh0.to(h0.dtype),
                dc0.to(c0.dtype))


def graves_lstm_scan(xw, rw, pi, pf, po, h0, c0):
    """(ys, cs) of the Graves-LSTM recurrence over xw (T, B, 4H); see the
    module docstring. Differentiable in every input."""
    return _GravesLstmScan.apply(xw, rw, pi, pf, po, h0, c0)


# ------------------------------------------------------------------ kernels
def _library():
    lib = build.load(SOURCE)
    if lib.dl4j_lstm_scan_fwd.argtypes is None:
        # fwd: xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, H, dtype, stream
        lib.dl4j_lstm_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        # bwd: xw, rw, rwt, pi, pf, po, h0, c0, ys, cs, dys, dcs, dxw, dh0,
        #      dc0, dp_part, drw, T, B, H, dtype, stream
        lib.dl4j_lstm_scan_bwd.argtypes = [ctypes.c_void_p] * 17 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.dl4j_lstm_scan_tile.argtypes = [ctypes.c_int] * 3
        for fn in (lib.dl4j_lstm_scan_fwd, lib.dl4j_lstm_scan_bwd,
                   lib.dl4j_lstm_scan_tile):
            fn.restype = ctypes.c_int
        lib.dl4j_lstm_scan_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_library():
    lib = build.load(SM90_SOURCE)
    if lib.dl4j_lstm_scan_fwd_cluster.argtypes is None:
        # xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, H, stream
        lib.dl4j_lstm_scan_fwd_cluster.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.dl4j_lstm_scan_fwd_clusters.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_scan_fwd_cluster_smem.argtypes = [ctypes.c_int]
        for fn in (lib.dl4j_lstm_scan_fwd_cluster,
                   lib.dl4j_lstm_scan_fwd_clusters,
                   lib.dl4j_lstm_scan_fwd_cluster_smem):
            fn.restype = ctypes.c_int
        lib.dl4j_lstm_scan_fwd_cluster_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_scan_fwd_cluster_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = build.load(BWD_SM90_SOURCE)
    if lib.dl4j_lstm_scan_bwd_cluster.argtypes is None:
        # xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs, dxw, dh0, dc0,
        # dp_part, T, B, H, stream
        lib.dl4j_lstm_scan_bwd_cluster.argtypes = [ctypes.c_void_p] * 15 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        # h0, ys, dxw, slab, T, B, H, chunks, stream
        lib.dl4j_lstm_drw_sm90.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.dl4j_lstm_drw_chunks.argtypes = [ctypes.c_int] * 3
        lib.dl4j_lstm_scan_bwd_clusters.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_scan_bwd_cluster_smem.argtypes = [ctypes.c_int]
        for fn in (lib.dl4j_lstm_scan_bwd_cluster, lib.dl4j_lstm_drw_sm90,
                   lib.dl4j_lstm_drw_chunks, lib.dl4j_lstm_scan_bwd_clusters,
                   lib.dl4j_lstm_scan_bwd_cluster_smem):
            fn.restype = ctypes.c_int
        lib.dl4j_lstm_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _padded(H: int) -> int:
    return -(-H // 16) * 16


def scan_fwd_variant(H: int, dtype: torch.dtype) -> str:
    """Which kernel runs K7's forward for a layer of H units in `dtype`
    on the card: "cluster" for bf16 at a padded H of 64, 128 or 256, else
    "tile". Read before the launch; neither falls back to the other."""
    return ("cluster" if dtype == torch.bfloat16
            and _padded(H) in CLUSTER_FWD_H else "tile")


def scan_bwd_variant(H: int, dtype: torch.dtype) -> str:
    """Which kernel runs K7's backward sweep for a layer of H units in
    `dtype` on the card: the same rule as the forward's, "cluster" for
    bf16 at a padded H of 64, 128 or 256, else "tile". Read before the
    launch; neither falls back to the other."""
    return scan_fwd_variant(H, dtype)


def reduce_drw_partials(slab: torch.Tensor) -> torch.Tensor:
    """dRW from the bf16 dRW kernel's (chunks, H, 4H) fp32 partials, summed
    in place by a pairwise tree in a fixed order (chunk z takes chunk z +
    n - n // 2 while n > 1 chunks are left), whatever ran first on the
    card: ceil(log2(chunks)) adds."""
    n = slab.shape[0]
    while n > 1:
        half = n // 2
        slab[:half] += slab[n - half:n]
        n -= half
    return slab[0]


def scan_fits(H: int, dtype: torch.dtype, device) -> bool:
    """Whether `graves_lstm_scan` runs a layer of H units in `dtype` on
    `device` in one piece: always on the CPU (the plain version), and on
    the card where the forward and backward tiles of the padded H fit in
    shared memory (builds the library on first use)."""
    if torch.device(device).type != "cuda" or dtype not in _DTYPE_CODE:
        return True
    lib = _library()
    Hp, code = _padded(H), _DTYPE_CODE[dtype]
    return bool(lib.dl4j_lstm_scan_tile(Hp, code, 0)
                and lib.dl4j_lstm_scan_tile(Hp, code, 1))


def _pad_gates(t: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """The last axis 4H -> 4Hp, each gate block [i|f|o|g] zero-padded."""
    if Hp == H:
        return t
    return torch.nn.functional.pad(t.unflatten(-1, (4, H)),
                                   (0, Hp - H)).flatten(-2)


def _cut_gates(t: torch.Tensor, H: int) -> torch.Tensor:
    Hp = t.shape[-1] // 4
    return t if Hp == H else t.unflatten(-1, (4, Hp))[..., :H].flatten(-2)


def _pad_last(t: torch.Tensor, Hp: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, Hp - t.shape[-1]))


def _pad_rw(rw: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """rw (H, 4H) -> (Hp, 4Hp): zero rows for the padded units' h, zero
    columns for their gates."""
    return _pad_gates(torch.nn.functional.pad(rw, (0, 0, 0, Hp - H)), H, Hp)


def padded_scan_fwd(fwd, xw, rw, pi, pf, po, h0, c0):
    """`fwd` (K7's forward or its plain version) at H padded to a multiple
    of 16; returns (ys, cs) at the true H."""
    H = rw.shape[0]
    Hp = _padded(H)
    if Hp == H:
        return fwd(xw, rw, pi, pf, po, h0, c0)
    ys, cs = fwd(_pad_gates(xw, H, Hp), _pad_rw(rw, H, Hp),
                 *(_pad_last(t, Hp) for t in (pi, pf, po, h0, c0)))
    return ys[..., :H], cs[..., :H]


def padded_scan_bwd(bwd, xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs):
    """`bwd` (K7's backward or its plain version) at H padded to a
    multiple of 16; returns the seven gradients at the true H."""
    H = rw.shape[0]
    Hp = _padded(H)
    if Hp == H:
        return bwd(xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs)
    dxw, drw, dpi, dpf, dpo, dh0, dc0 = bwd(
        _pad_gates(xw, H, Hp), _pad_rw(rw, H, Hp),
        *(_pad_last(t, Hp) for t in (pi, pf, po, h0, c0, ys, cs, dys,
                                     dcs)))
    return (_cut_gates(dxw, H), _cut_gates(drw[:H], H), dpi[:H], dpf[:H],
            dpo[:H], dh0[:, :H], dc0[:, :H])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous with a 32-byte-aligned start (wmma loads rw
    fragments straight from global memory)."""
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def _on_card(what, xw):
    if xw.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors only")


def _check(what, bwd, xw, rw, *state):
    """(T, B, H, the library) after checking the inputs; builds the
    library on first use."""
    if xw.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {xw.dtype} has no kernel on the card "
                        "(float32, bfloat16)")
    T, B, H4 = xw.shape
    H = H4 // 4
    if tuple(rw.shape) != (H, 4 * H) or H4 != 4 * H:
        raise ValueError(f"{what}: xw {tuple(xw.shape)} and rw "
                         f"{tuple(rw.shape)} do not match (T, B, 4H) / "
                         "(H, 4H)")
    for s in state:
        if s.dtype != xw.dtype or s.device != xw.device:
            raise TypeError(f"{what}: every input must share xw's dtype "
                            f"{xw.dtype} and device")
    lib = _library()
    if lib.dl4j_lstm_scan_tile(H, _DTYPE_CODE[xw.dtype], int(bwd)) == 0:
        raise ValueError(
            f"{what}: H = {H} is not supported by the CUDA scan in "
            f"{xw.dtype}: H must be a multiple of 16 and a 16-row batch tile "
            "(8 in fp32) of the sweep's state must fit in shared memory")
    return T, B, H, lib


def _launch(fn, error_string, what, *args):
    """Call a library entry point; raise with the library's message for a
    non-zero return."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{error_string(err).decode()}")


def graves_lstm_scan_fwd_cuda(xw, rw, pi, pf, po, h0, c0):
    """K7 forward on CUDA tensors; same contract as
    `graves_lstm_scan_plain` (h0/c0 are taken in xw's dtype), any H whose
    padded tile fits."""
    _on_card("graves_lstm_scan_fwd", xw)
    return padded_scan_fwd(_scan_fwd_launch, xw, rw, pi, pf, po,
                           h0.to(xw.dtype), c0.to(xw.dtype))


def _scan_fwd_launch(xw, rw, pi, pf, po, h0, c0):
    T, B, H, lib = _check("graves_lstm_scan_fwd", False, xw, rw, pi, pf,
                          po, h0, c0)
    variant = scan_fwd_variant(H, xw.dtype)
    # the cluster kernel reads rw, h0 and c0 16 bytes at a time
    xw, rw, h0 = _aligned(xw), _aligned(rw), _aligned(h0)
    pi, pf, po, c0 = (t.contiguous() for t in (pi, pf, po, c0))
    ys = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    cs = torch.empty_like(ys)
    ptrs = (xw.data_ptr(), rw.data_ptr(), pi.data_ptr(), pf.data_ptr(),
            po.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
            cs.data_ptr(), T, B, H)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    if variant == "cluster":
        clib = _cluster_library()
        _launch(clib.dl4j_lstm_scan_fwd_cluster,
                clib.dl4j_lstm_scan_fwd_cluster_error_string,
                "graves_lstm_scan_fwd (cluster)", *ptrs, stream)
    else:
        _launch(lib.dl4j_lstm_scan_fwd, lib.dl4j_lstm_scan_error_string,
                "graves_lstm_scan_fwd", *ptrs, _DTYPE_CODE[xw.dtype], stream)
    graves_lstm_scan_fwd_cuda.launches += 1
    graves_lstm_scan_fwd_cuda.variant_launches[variant] += 1
    return ys, cs


def graves_lstm_scan_bwd_cuda(xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs):
    """K7 backward on CUDA tensors (the reverse sweep of the variant
    `scan_bwd_variant` names, then the dRW kernel); same contract as
    `graves_lstm_scan_bwd_plain`, any H whose padded tile fits. Counted in
    `.launches` and `.variant_launches` once both kernels launched."""
    _on_card("graves_lstm_scan_bwd", xw)
    dt = xw.dtype
    return padded_scan_bwd(_scan_bwd_launch, xw, rw, pi, pf, po,
                           *(t.to(dt) for t in (h0, c0)), ys, cs,
                           *(t.to(dt) for t in (dys, dcs)))


def _scan_bwd_launch(xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs):
    dt = xw.dtype
    T, B, H, lib = _check("graves_lstm_scan_bwd", True, xw, rw, pi, pf, po,
                          h0, c0, ys, cs, dys, dcs)
    variant = scan_bwd_variant(H, dt)
    # the cluster sweep and the dRW kernels read h0, ys, cs, dys, dcs and
    # xw 16 bytes at a time (dRW by TMA)
    xw, rw, h0, c0, ys, cs, dys, dcs = (
        _aligned(t) for t in (xw, rw, h0, c0, ys, cs, dys, dcs))
    rwt = rw.t().contiguous() if dt == torch.float32 else None
    pi, pf, po = (t.contiguous() for t in (pi, pf, po))
    dxw = torch.empty_like(xw)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    tile = CLUSTER_ROWS if variant == "cluster" else lib.dl4j_lstm_scan_tile(
        H, _DTYPE_CODE[dt], 1)
    dp = torch.empty((-(-B // tile), 3, H), dtype=torch.float32,
                     device=xw.device)
    ins = (xw.data_ptr(), rw.data_ptr(), pi.data_ptr(), pf.data_ptr(),
           po.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
           cs.data_ptr(), dys.data_ptr(), dcs.data_ptr())
    outs = (dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), dp.data_ptr())
    # fp32: the tile sweep, then its split-K dRW into a zeroed buffer;
    # bf16: either sweep, then the wgmma dRW's chunk partials
    drw = torch.zeros((H, 4 * H), dtype=torch.float32, device=xw.device) \
        if dt == torch.float32 else None
    if variant == "cluster":
        blib = _bwd_library()
        _launch(blib.dl4j_lstm_scan_bwd_cluster,
                blib.dl4j_lstm_scan_bwd_error_string,
                "graves_lstm_scan_bwd (cluster sweep)", *ins, *outs, T, B, H,
                stream)
    else:
        _launch(lib.dl4j_lstm_scan_bwd, lib.dl4j_lstm_scan_error_string,
                "graves_lstm_scan_bwd", ins[0], ins[1],
                None if rwt is None else rwt.data_ptr(), *ins[2:], *outs,
                None if drw is None else drw.data_ptr(), T, B, H,
                _DTYPE_CODE[dt], stream)
    if drw is None:
        blib = _bwd_library()
        chunks = blib.dl4j_lstm_drw_chunks(T, B, H)
        slab = torch.empty((chunks, H, 4 * H), dtype=torch.float32,
                           device=xw.device)
        _launch(blib.dl4j_lstm_drw_sm90, blib.dl4j_lstm_scan_bwd_error_string,
                "graves_lstm_scan_bwd (dRW)", h0.data_ptr(), ys.data_ptr(),
                dxw.data_ptr(), slab.data_ptr(), T, B, H, chunks, stream)
        drw = reduce_drw_partials(slab)
    graves_lstm_scan_bwd_cuda.launches += 1
    graves_lstm_scan_bwd_cuda.variant_launches[variant] += 1
    dp = dp.sum(0)                          # (3, H) fp32, over the CTAs
    return (dxw, drw.to(rw.dtype), dp[0].to(pi.dtype), dp[1].to(pf.dtype),
            dp[2].to(po.dtype), dh0, dc0)


graves_lstm_scan_fwd_cuda.launches = 0
graves_lstm_scan_fwd_cuda.variant_launches = dict.fromkeys(FWD_VARIANTS, 0)
graves_lstm_scan_bwd_cuda.launches = 0
graves_lstm_scan_bwd_cuda.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
register_helper("graves_lstm_scan_fwd")(graves_lstm_scan_fwd_cuda)
register_helper("graves_lstm_scan_bwd")(graves_lstm_scan_bwd_cuda)
