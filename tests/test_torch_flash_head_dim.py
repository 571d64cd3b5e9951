"""Flash attention at head dims above 128 (the port's K3, K4 and K5 at any
head dim), in float64 on the CPU.

The port's plain versions, alone and inside the head-dim padding the CUDA
wrappers apply (`padded_fwd` / `padded_bwd`: 160 -> 192, 320 -> 384, 256,
512, 640 and 1024 as they are, above 512 up to a multiple of 128),
against the JAX package's `flash_attention_lse` (its Pallas kernels in
interpret mode, small tiles, compiled once by `jax.jit` through a module
fixture), forward and the backward of both schedules, with a non-zero lse
cotangent; tolerance 1e-10. Padding is exact. On the card bf16 K3, K4
and K5 at D 192 to 512 run on the wgmma kernels of
flash_attention_sm90.cu, the rest on the CUDA-core kernels of
flash_attention.cu (bf16 widened to fp32; above 512 the kernels that
stream the head dim in chunks): the route and the launches at those head
dims run here against a recording stand-in library. The kernels
themselves are held against the plain versions on the card by
chip_smoke.py (flash_head_dims and the kernel sweeps).
"""
import re
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

ATOL = 1e-10
BLK = 8
B, H, T = 1, 2, 13


def _data(D, seed, masked):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D) * 0.3 for _ in range(3))
    do = rng.randn(B, H, T, D)
    dlse = rng.randn(B, H, T) * 0.2
    m = (rng.rand(B, T) > 0.3).astype(np.float64) if masked else None
    return q, k, v, do, dlse, m


def _jax_fwd_bwd(q, k, v, m, do, dlse, causal, window):
    def f(q, k, v):
        return jfa.flash_attention_lse(q, k, v, m, causal, None, BLK, BLK,
                                       window)
    (o, lse), vjp = jax.vjp(f, q, k, v)
    return o, lse, vjp((do, dlse))


@pytest.fixture(scope="module")
def jax_flash():
    return jax.jit(_jax_fwd_bwd, static_argnames=("causal", "window"))


CASES = [(160, True, 0, False), (160, False, 5, True), (256, True, 5, True),
         (256, False, 0, False), (320, True, 5, True), (320, False, 0, False),
         (512, True, 0, True), (512, False, 5, False), (640, True, 5, True),
         (1024, False, 0, False)]


@pytest.mark.parametrize("D,causal,window,masked", CASES)
def test_plain_matches_jax_at_wide_head_dims(jax_flash, D, causal, window,
                                             masked):
    q, k, v, do, dlse, m = _data(D, seed=D + window, masked=masked)
    jm = None if m is None else jnp.asarray(m)
    ro, rlse, rgrads = jax_flash(*map(jnp.asarray, (q, k, v)), jm,
                                 jnp.asarray(do), jnp.asarray(dlse),
                                 causal=causal, window=window)
    tq, tk, tv, tdo, tdlse = map(torch.from_numpy, (q, k, v, do, dlse))
    tm = None if m is None else torch.from_numpy(m)
    # the plain versions at the true D, through the autograd function
    for bwd in tfa.BWD_MODES:
        xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        o, lse = tfa.flash_attention_lse(*xs, tm, causal, None, window, bwd)
        grads = torch.autograd.grad((o, lse), xs, (tdo, tdlse))
        np.testing.assert_allclose(o.detach(), ro, atol=ATOL, rtol=0)
        np.testing.assert_allclose(lse.detach(), rlse, atol=ATOL, rtol=0)
        for g, r in zip(grads, rgrads):
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
    # the same inside the padding the CUDA wrappers put around the kernels
    po, plse = tfa.padded_fwd(tfa.flash_fwd_plain, tq, tk, tv, tm, causal,
                              None, window)
    np.testing.assert_allclose(po, ro, atol=ATOL, rtol=0)
    np.testing.assert_allclose(plse, rlse, atol=ATOL, rtol=0)
    for bwd in tfa.BWD_MODES:
        pg = tfa.padded_bwd(tfa.flash_bwd_plain, tq, tk, tv, tm, po, plse,
                            tdo, tdlse, causal, None, window, bwd)
        for g, r in zip(pg, rgrads):
            assert g.shape == (B, H, T, D)
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("D,Dp", [(129, 192), (160, 192), (192, 192),
                                  (200, 256), (256, 256), (257, 384),
                                  (320, 384), (400, 512), (512, 512),
                                  (600, 640)])
def test_wide_head_dims_pad_exactly(D, Dp):
    """Above 128 the kernel head dim is 192, 256, 384 or 512, and above 512
    the next multiple of 128; zero columns add 0 to every score and
    output, at the scale of the true D."""
    assert tfa._kernel_head_dim(D) == Dp
    q, k, v, do, dlse, m = (None if a is None else torch.from_numpy(a)
                            for a in _data(D, seed=1, masked=True))
    o, lse = tfa.flash_fwd_plain(q, k, v, m, True, None, 3)
    po, plse = tfa.padded_fwd(tfa.flash_fwd_plain, q, k, v, m, True, None,
                              3)
    torch.testing.assert_close(po, o, rtol=0, atol=ATOL)
    torch.testing.assert_close(plse, lse, rtol=0, atol=ATOL)
    ref = tfa.flash_bwd_plain(q, k, v, m, o, lse, do, dlse, True, None, 3)
    got = tfa.padded_bwd(tfa.flash_bwd_plain, q, k, v, m, o, lse, do, dlse,
                         True, None, 3)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("D,Dp", [(513, 640), (768, 768), (1024, 1024)])
def test_head_dims_above_512_raise_naming_queue_3(D, Dp):
    """Head dims above 512 raised until ROADMAP.md queue 3's fault was
    repaired; now they pad to the next multiple of 128, and the padded
    plain K3, K4 and K5 equal the unpadded ones."""
    assert tfa._kernel_head_dim(D) == Dp
    q, k, v, do, dlse, m = (torch.from_numpy(a)
                            for a in _data(D, seed=D, masked=True))
    o, lse = tfa.flash_fwd_plain(q, k, v, m, True, None, 4)
    po, plse = tfa.padded_fwd(tfa.flash_fwd_plain, q, k, v, m, True, None,
                              4)
    assert po.shape == o.shape
    torch.testing.assert_close(po, o, rtol=0, atol=ATOL)
    torch.testing.assert_close(plse, lse, rtol=0, atol=ATOL)
    for bwd in tfa.BWD_MODES:
        ref = tfa.flash_bwd_plain(q, k, v, m, o, lse, do, dlse, True, None,
                                  4, bwd)
        got = tfa.padded_bwd(tfa.flash_bwd_plain, q, k, v, m, o, lse, do,
                             dlse, True, None, 4, bwd)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            torch.testing.assert_close(g, r, rtol=0, atol=ATOL)


# the largest head dim of the wgmma kernels of K3, K4 and K5
SM90_MAX_D = 512


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["fwd", "fused", "two_pass"])
def test_route_by_head_dim(dtype, kind):
    """bf16 K3, K4 and K5 take the wgmma kernels up to D 512; above, and
    fp32 at every D, the CUDA-core kernels. Only kernel head dims are
    routed: HEAD_DIMS, then multiples of 128."""
    assert tfa.SM90_MAX_D == SM90_MAX_D
    for D in tfa.HEAD_DIMS + (640, 1024, 1536):
        want = tfa.SM90_SOURCE if (dtype == torch.bfloat16
                                   and D <= SM90_MAX_D) else tfa.SOURCE
        assert tfa._route(dtype, kind, D) == want
    for D in (160, 600, 1000):
        with pytest.raises(ValueError):
            tfa._route(dtype, kind, D)


class _FakeFn:
    def __init__(self, name, log, err):
        self.name, self.log, self.err = name, log, err
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        self.log.append((self.name, args))
        return self.err


class _FakeLib:
    NAMES = ("dl4j_flash_fwd", "dl4j_flash_bwd", "dl4j_flash_error_string",
             "dl4j_flash_sm90_fwd", "dl4j_flash_sm90_bwd",
             "dl4j_flash_sm90_bwd_fused", "dl4j_flash_sm90_smem",
             "dl4j_flash_sm90_error_string")

    def __init__(self, err=0):
        self.log = []
        for n in self.NAMES:
            setattr(self, n, _FakeFn(n, self.log, err))


@pytest.fixture
def fake_libs(monkeypatch):
    """The real `_library` set-up on stand-in libraries and a stand-in
    stream; the launch counters are restored afterwards."""
    libs = {}
    for fn in (tfa.flash_attention_fwd_cuda, tfa.flash_attention_bwd_cuda):
        for name in ("launches", "fused_launches", "two_pass_launches"):
            if hasattr(fn, name):
                monkeypatch.setattr(fn, name, getattr(fn, name))
        monkeypatch.setattr(fn, "route_launches", dict(fn.route_launches))

    def install(err=0):
        monkeypatch.setattr(tfa.build, "load", lambda source: libs.setdefault(
            source, _FakeLib(err)))
        monkeypatch.setattr(
            torch.cuda, "current_stream",
            lambda device=None: SimpleNamespace(cuda_stream=91))
        return libs
    return install


def _bf16(D):
    q, k, v, do, _, m = _data(D, seed=D, masked=True)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in (q, k, v, do))
    return q, k, v, do, torch.from_numpy(m)


@pytest.mark.parametrize("D", [192, 256, 384, 512])
def test_wide_bf16_forward_launch_source(fake_libs, D):
    """bf16 K3 at D 192 to 512 launches the wgmma kernel on the bf16
    tensors themselves (at 384 and 512 the split kernel, which until then
    was the CUDA-core kernel on them widened to fp32)."""
    libs = fake_libs()
    q, k, v, _, m = _bf16(D)
    launches = tfa.flash_attention_fwd_cuda.launches
    routes = dict(tfa.flash_attention_fwd_cuda.route_launches)
    o, lse = tfa._fwd_launch(q, k, v, m, True, 0.125, 0)
    source = tfa.SM90_SOURCE
    assert list(libs) == [source]
    ((name, args),) = libs[source].log
    fn = getattr(libs[source], name)
    assert len(args) == len(fn.argtypes)
    assert name == "dl4j_flash_sm90_fwd" and args[0] == q.data_ptr()
    assert args[6:13] == (B, H, H, T, D, 1, 0)
    assert args[-2:] == (0.125, 91)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    assert tfa.flash_attention_fwd_cuda.launches == launches + 1
    routes[source] += 1
    assert tfa.flash_attention_fwd_cuda.route_launches == routes


@pytest.mark.parametrize("D", [192, 256, 384, 512])
@pytest.mark.parametrize("mode", ["fused", "two_pass"])
def test_wide_bf16_backward_launch_source(fake_libs, D, mode):
    """bf16 K4 and K5 at D 192 to 512 launch the wgmma kernels on the bf16
    tensors themselves, one launch a call counted under its schedule (K4
    at 384 and 512 the split kernel, which until then was the CUDA-core
    kernel on them widened to fp32)."""
    libs = fake_libs()
    q, k, v, do, m = _bf16(D)
    o = torch.zeros_like(q)
    lse = torch.zeros(B, H, T)
    counts = (tfa.flash_attention_bwd_cuda.fused_launches,
              tfa.flash_attention_bwd_cuda.two_pass_launches)
    routes = dict(tfa.flash_attention_bwd_cuda.route_launches)
    dq, dk, dv = tfa._bwd_launch(q, k, v, m, o, lse, do, None, False, 0.25,
                                 4, mode)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dq.shape == dk.shape == dv.shape == q.shape
    two = mode == "two_pass"
    source = tfa.SM90_SOURCE
    assert list(libs) == [source]
    ((name, args),) = libs[source].log
    fn = getattr(libs[source], name)
    assert len(args) == len(fn.argtypes)
    assert name == ("dl4j_flash_sm90_bwd" if two
                    else "dl4j_flash_sm90_bwd_fused")
    assert args[0] == q.data_ptr() and args[4] == do.data_ptr()
    assert args[10:16] == (B, H, T, D, 0, 4)
    assert args[-2:] == (0.25, 91)
    assert (tfa.flash_attention_bwd_cuda.fused_launches,
            tfa.flash_attention_bwd_cuda.two_pass_launches) == (
        counts[0] + (not two), counts[1] + 2 * two)
    routes[source] += 1
    assert tfa.flash_attention_bwd_cuda.route_launches == routes


@pytest.mark.parametrize("D,Dp", [(600, 640), (1024, 1024)])
def test_head_dims_above_512_launch_the_fp32_kernels_padded(fake_libs, D,
                                                            Dp):
    """Above 512 both dtypes launch the CUDA-core kernels at the head dim
    padded to a multiple of 128, the chunk those kernels stream D in (bf16
    widened to fp32); the outputs come back at the true D in the input
    dtype."""
    src = (tfa.build.CSRC / tfa.SOURCE).read_text()
    assert re.search(r"constexpr int DCH = (\d+);", src).group(1) == str(
        tfa.WIDE_CHUNK)
    libs = fake_libs()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, m = (t.to(dtype) for t in _bf16(D))
        o, lse = tfa.padded_fwd(tfa._fwd_launch, q, k, v, m, True, None, 3)
        assert o.shape == q.shape and o.dtype == dtype
        for mode in tfa.BWD_MODES:
            grads = tfa.padded_bwd(tfa._bwd_launch, q, k, v, m, o, lse, do,
                                   None, True, None, 3, mode)
            assert all(g.shape == q.shape and g.dtype == dtype
                       for g in grads)
    assert list(libs) == [tfa.SOURCE]
    log = libs[tfa.SOURCE].log
    assert [name for name, _ in log] == [
        "dl4j_flash_fwd", "dl4j_flash_bwd", "dl4j_flash_bwd"] * 2
    scale = 1 / np.sqrt(D)
    for name, args in log:
        if name == "dl4j_flash_fwd":
            assert args[6:14] == (B, H, H, T, Dp, 1, 3, 0)
        else:
            assert args[10:17] == (B, H, T, Dp, 1, 3, 0)
        assert args[-2] == pytest.approx(scale, rel=1e-12)


def test_bf16_at_128_still_takes_the_wgmma_kernel(fake_libs):
    libs = fake_libs()
    q, k, v, _, m = _bf16(128)
    tfa._fwd_launch(q, k, v, m, True, 0.125, 0)
    assert list(libs) == [tfa.SM90_SOURCE]
    ((name, args),) = libs[tfa.SM90_SOURCE].log
    assert name == "dl4j_flash_sm90_fwd" and args[0] == q.data_ptr()


@pytest.mark.parametrize("D", [192, 256, 384, 512, 640])
def test_wide_failed_launch_raises_and_counts_nothing(fake_libs, D):
    """A launch the library refuses raises, names the library's error and
    counts nothing: at D 192 to 512 K3, K4 and K5 on the wgmma kernels,
    at 640 on the CUDA-core ones (no fallback from one library to the
    other)."""
    libs = fake_libs(err=700)
    q, k, v, do, m = _bf16(D)
    before = (tfa.flash_attention_fwd_cuda.launches,
              dict(tfa.flash_attention_fwd_cuda.route_launches),
              tfa.flash_attention_bwd_cuda.fused_launches,
              tfa.flash_attention_bwd_cuda.two_pass_launches,
              dict(tfa.flash_attention_bwd_cuda.route_launches))
    sm90 = D <= SM90_MAX_D
    with pytest.raises(RuntimeError, match="error 700 from dl4j_flash_" + (
            "sm90_" if sm90 else "")):
        tfa._fwd_launch(q, k, v, m, True, 0.125, 0)
    for mode in tfa.BWD_MODES:
        with pytest.raises(RuntimeError, match="error 700 from dl4j_flash_"
                           + ("sm90_" if sm90 else "error")):
            tfa._bwd_launch(q, k, v, m, torch.zeros_like(q),
                            torch.zeros(B, H, T), do, None, True, 0.125, 0,
                            mode)
    want = {}
    for name in ("fwd", "bwd_fused", "bwd"):
        if sm90:
            want.setdefault(tfa.SM90_SOURCE, []).append(
                f"dl4j_flash_sm90_{name}")
        else:
            want.setdefault(tfa.SOURCE, []).append(
                f"dl4j_flash_{name.replace('_fused', '')}")
    assert {src: [name for name, _ in lib.log]
            for src, lib in libs.items()} == want
    assert (tfa.flash_attention_fwd_cuda.launches,
            tfa.flash_attention_fwd_cuda.route_launches,
            tfa.flash_attention_bwd_cuda.fused_launches,
            tfa.flash_attention_bwd_cuda.two_pass_launches,
            tfa.flash_attention_bwd_cuda.route_launches) == before
