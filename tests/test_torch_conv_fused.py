"""The port's fused 1x1 conv + BatchNorm (deeplearning4j_tpu_torch/ops/
conv_fused) against the JAX package's, on the CPU.

- K10's plain version, `conv1x1_stats_plain`, against the Pallas kernel
  `conv1x1_stats_pallas` in interpret mode (as tests/test_conv_fused.py
  runs it), with a ragged P (200 at p_tile 128): float64 within 1e-10,
  bfloat16 with fp32 sums within 1e-5 relative and y within one bf16 ulp.
- `conv1x1_bn_act` forward and its five gradients (with non-zero
  cotangents on mean and var) against the JAX custom VJP and against
  `conv1x1_bn_act_xla`, in float64 within 1e-9; the port's unfused oracle
  against `conv1x1_bn_act_xla` too.
- The mini bottleneck graph of tests/test_torch_graph.py in bf16 compute
  over fp32 parameters, against the JAX package with its helpers on (its
  fused Pallas route): outputs within bf16's 2^-7 relative, the loss
  within 1e-3 and the gradient within 2e-2 in norm (the port recomputes y
  in bf16 in the fused backward, the JAX package in fp32).
- The CUDA wrapper refuses CPU tensors. The bf16 kernel's load path is
  chosen from P before the launch (TMA where x's rows are 16-byte
  aligned, cp.async or 2-byte loads elsewhere), and the launch runs
  against a recording stand-in library: the function, its arguments
  against its argtypes, W padded to a multiple of 8 columns, the launch
  counters per path, and a failed launch. The kernel itself is held
  against the plain version on the card by chip_smoke.py.
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.conv_fused import (conv1x1_bn_act,
                                               conv1x1_bn_act_xla,
                                               conv1x1_stats_pallas)
from deeplearning4j_tpu.ops.helpers import enable_helpers
from deeplearning4j_tpu_torch.ops import conv_fused as tcf
from test_torch_graph import _batch, _jax_gradient_and_score, _mini, _port

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

TOL = 1e-10
GRAD_TOL = 1e-9


def _data(B=3, C_in=8, C_out=6, H=5, W=5, seed=0, mean_shift=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C_in, H, W) + mean_shift
    w = rng.randn(C_out, C_in) * 0.3
    gamma = 1.0 + 0.1 * rng.randn(C_out)
    beta = 0.1 * rng.randn(C_out)
    bias = 0.1 * rng.randn(C_out)
    return x, w, gamma, beta, bias


@pytest.mark.parametrize("B,C_in,C_out,P,p_tile", [
    (3, 16, 8, 200, 128), (2, 8, 5, 49, 1024), (1, 4, 3, 16, 1024)])
def test_stats_plain_matches_pallas_fp64(B, C_in, C_out, P, p_tile):
    rng = np.random.RandomState(P)
    x3 = rng.randn(B, C_in, P)
    w = rng.randn(C_out, C_in) * 0.3
    y, s1, s2 = conv1x1_stats_pallas(jnp.asarray(x3), jnp.asarray(w),
                                     p_tile=p_tile)
    ty, t1, t2 = tcf.conv1x1_stats_plain(torch.from_numpy(x3),
                                         torch.from_numpy(w))
    assert ty.dtype == torch.float64 and t1.dtype == torch.float64
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=0, atol=TOL)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t2.numpy(), np.asarray(s2), rtol=TOL,
                               atol=TOL)


def test_stats_plain_matches_pallas_bf16():
    rng = np.random.RandomState(5)
    x3 = jnp.asarray(rng.randn(3, 16, 200), jnp.bfloat16)
    w = jnp.asarray(rng.randn(8, 16) * 0.3, jnp.bfloat16)
    y, s1, s2 = conv1x1_stats_pallas(x3, w, p_tile=128)
    assert s1.dtype == jnp.float32
    tx = torch.from_numpy(np.array(x3.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).bfloat16()
    ty, t1, t2 = tcf.conv1x1_stats_plain(tx, tw)
    assert ty.dtype == torch.bfloat16 and t1.dtype == torch.float32
    yj = np.asarray(y.astype(jnp.float32))
    # y: the same fp32 sums of exact bf16 products, rounded once; a sum
    # taken in another order may round to the neighbouring bf16 value
    np.testing.assert_allclose(ty.float().numpy(), yj, rtol=2 ** -8,
                               atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(t2.numpy(), np.asarray(s2), rtol=1e-5)


def _jax_loss(fn, relu, stride, cot):
    c_out, c_m, c_v = (jnp.asarray(c) for c in cot)

    def loss(x, w, gamma, beta, bias):
        out, m, v = fn(x, w, gamma, beta, bias, 1e-5, relu, stride)
        return jnp.sum(out * c_out) + jnp.sum(m * c_m) + jnp.sum(v * c_v)
    return loss


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_forward_and_gradients_match_jax(relu, stride):
    args = _data(seed=stride + 2 * relu)
    rng = np.random.RandomState(9)
    Ho = (5 - 1) // stride + 1
    cot = (rng.randn(3, 6, Ho, Ho), rng.randn(6), rng.randn(6))
    jargs = [jnp.asarray(a) for a in args]
    j_out = jax.jit(conv1x1_bn_act, static_argnums=(5, 6, 7))(
        *jargs, 1e-5, relu, stride)
    x_out = conv1x1_bn_act_xla(*jargs, 1e-5, relu, stride)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    t_out = tcf.conv1x1_bn_act(*targs, 1e-5, relu, stride)
    p_out = tcf.conv1x1_bn_act_plain(*(torch.from_numpy(a) for a in args),
                                     1e-5, relu, stride)
    for j, x, t, p in zip(j_out, x_out, t_out, p_out):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(x),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(p.numpy(), np.asarray(x), rtol=0,
                                   atol=TOL)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(t_out, cot))
    t_grads = torch.autograd.grad(loss, targs)
    j_grads = jax.jit(jax.grad(_jax_loss(conv1x1_bn_act, relu, stride, cot),
                               argnums=(0, 1, 2, 3, 4)))(*jargs)
    x_grads = jax.grad(_jax_loss(conv1x1_bn_act_xla, relu, stride, cot),
                       argnums=(0, 1, 2, 3, 4))(*jargs)
    for name, t, j, x in zip(("dx", "dw", "dgamma", "dbeta", "dbias"),
                             t_grads, j_grads, x_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), np.asarray(x), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_fused_large_channel_mean_fp64():
    """|mean| >> std: the one-pass statistics in fp64 stay within 1e-9 of
    the two-pass reference."""
    args = _data(seed=4, mean_shift=50.0)
    t = tcf.conv1x1_bn_act(*(torch.from_numpy(a) for a in args), 1e-5,
                           True, 1)
    x = conv1x1_bn_act_xla(*(jnp.asarray(a) for a in args), 1e-5, True, 1)
    for a, b in zip(t, x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tcf.conv1x1_stats_cuda(torch.zeros(2, 4, 9), torch.zeros(3, 4))


def test_mini_bottleneck_matches_jax_bf16():
    x, y = _batch(np.float32)
    enable_helpers(True)
    try:
        jnet = _mini("float32", "bfloat16")
        tnet = _port(jnet)
        jo = np.asarray(jnet.output(x))
        np.testing.assert_allclose(tnet.output(x).numpy(), jo,
                                   rtol=2 ** -7, atol=2 ** -7)
        jg, jl = _jax_gradient_and_score(jnet, x, y)
        tg, tl = tnet.gradient_and_score(x, y)
        assert abs(tl - jl) < 1e-3
        jg, tg = np.asarray(jg), tg.numpy()
        assert np.linalg.norm(tg - jg) / np.linalg.norm(jg) < 2e-2
    finally:
        enable_helpers(False)


# P of ResNet50's 1x1 pairs at 224x224 (784, 196, 49, 16) and of the
# card's sweep (1, 200, 81), with the load path each takes
@pytest.mark.parametrize("P,C_in,C_out,path", [
    (784, 64, 256, "tma_image"), (200, 8, 3, "tma_image"),
    (72, 12, 8, "tma_image"), (16, 512, 2048, "tma_images"),
    (32, 8, 5, "tma_images"), (64, 4, 8, "tma_images"),
    (196, 128, 512, "cp_async"), (24, 8, 40, "cp_async"),
    (8, 64, 64, "cp_async"), (2, 3, 7, "cp_async"),
    (49, 256, 1024, "bulk"), (1, 8, 8, "bulk"), (127, 64, 8, "bulk"),
    (129, 64, 64, "ld_st"), (81, 24, 44, "ld_st"), (49, 12, 16, "ld_st")])
def test_k10_load_path_follows_the_row_alignment(P, C_in, C_out, path):
    assert tcf.conv1x1_load_path(P, C_in, C_out) == path
    if path.startswith("tma"):
        assert (2 * P) % 16 == 0       # a TMA map needs 16-byte strides
    if path == "bulk":
        # 64 rows of x[b] and 128 rows of y[b] are 16-byte-aligned runs,
        # and whole images fill a 128-column tile
        assert P % 2 == 1 and 1 <= 128 // P
        assert (C_in * P * 2) % 16 == 0 and (C_out * P * 2) % 16 == 0


class _FakeFn:
    def __init__(self, name, log, ret):
        self.name, self.log, self.ret = name, log, ret
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        self.log.append((self.name, args))
        return self.ret


class _FakeConvLib:
    def __init__(self, err=0, tiles=5):
        self.log = []
        self.dl4j_conv1x1_stats = _FakeFn("dl4j_conv1x1_stats", self.log,
                                          err)
        self.dl4j_conv1x1_tiles = _FakeFn("dl4j_conv1x1_tiles", self.log,
                                          tiles)
        self.dl4j_conv1x1_error_string = _FakeFn(
            "dl4j_conv1x1_error_string", self.log, None)
        self.dl4j_conv1x1_smem = _FakeFn("dl4j_conv1x1_smem", self.log, 0)


def _fake_conv(monkeypatch, err=0):
    lib = _FakeConvLib(err)
    monkeypatch.setattr(tcf.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=77))
    return lib


@pytest.mark.parametrize("P", [784, 196, 49, 16])
@pytest.mark.parametrize("C_in", [64, 12])
def test_k10_launch_reaches_its_kernel(monkeypatch, P, C_in):
    """The real library set-up and launch of the bf16 kernel on a stand-in
    library: argtypes, the arguments (W padded to 8 columns with zeros),
    the partials' rows from the library, and the launch counters."""
    lib = _fake_conv(monkeypatch)
    x3 = torch.randn(2, C_in, P).bfloat16()
    w = torch.randn(24, C_in).bfloat16()
    path = tcf.conv1x1_load_path(P, C_in, 24)
    before = tcf.conv1x1_stats_cuda.launches
    by_path = dict(tcf.conv1x1_stats_cuda.path_launches)
    y, s1, s2 = tcf._conv1x1_launch(x3, w)
    assert tcf.conv1x1_stats_cuda.launches == before + 1
    by_path[path] += 1
    assert tcf.conv1x1_stats_cuda.path_launches == by_path
    (tname, targs), (name, args) = lib.log
    assert (tname, targs) == ("dl4j_conv1x1_tiles",
                              (2, P, C_in, 24, 2,
                               tcf.LOAD_PATHS.index(path)))
    fn = lib.dl4j_conv1x1_stats
    assert name == "dl4j_conv1x1_stats"
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    assert lib.dl4j_conv1x1_tiles.restype == ctypes.c_long
    assert len(args) == len(fn.argtypes)
    ldw = -(-C_in // 8) * 8
    assert args[4:] == (2, C_in, ldw, 24, P, 2, tcf.LOAD_PATHS.index(path),
                        77)
    assert args[0] == x3.data_ptr() and args[2] == y.data_ptr()
    assert (args[1] == w.data_ptr()) == (ldw == C_in)
    assert y.shape == (2, 24, P) and y.dtype == torch.bfloat16
    assert s1.shape == s2.shape == (24,) and s1.dtype == torch.float32


def test_k10_fp32_launch_keeps_its_kernel(monkeypatch):
    lib = _fake_conv(monkeypatch)
    x3, w = torch.randn(3, 12, 49), torch.randn(5, 12)
    by_path = dict(tcf.conv1x1_stats_cuda.path_launches)
    y, s1, _ = tcf._conv1x1_launch(x3, w)
    (_, targs), (_, args) = lib.log
    assert targs == (3, 49, 12, 5, 0, 0)
    assert args[1] == w.data_ptr() and args[4:] == (3, 12, 12, 5, 49, 0, 0,
                                                     77)
    assert tcf.conv1x1_stats_cuda.path_launches == by_path
    assert y.dtype == torch.float32 and s1.dtype == torch.float64


def test_k10_failed_launch_raises(monkeypatch):
    _fake_conv(monkeypatch, err=700)
    before = tcf.conv1x1_stats_cuda.launches
    by_path = dict(tcf.conv1x1_stats_cuda.path_launches)
    with pytest.raises(RuntimeError, match="error 700 from "
                       "dl4j_conv1x1_error_string"):
        tcf._conv1x1_launch(torch.randn(2, 8, 16).bfloat16(),
                            torch.randn(4, 8).bfloat16())
    assert tcf.conv1x1_stats_cuda.launches == before
    assert tcf.conv1x1_stats_cuda.path_launches == by_path
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcf._conv1x1_launch(torch.randn(2, 8, 16).half(),
                            torch.randn(4, 8).half())
