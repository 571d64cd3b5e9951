"""The port's flash attention (deeplearning4j_tpu_torch/ops/flash_attention)
against the JAX package's, in float64 on the CPU.

On the CPU the port runs the plain versions of K3, K4 and K5
(`flash_fwd_plain`, `flash_bwd_plain`) behind its autograd function; the
JAX side runs its Pallas kernels in interpret mode with explicit small
tiles (bq = bk = 8, so T = 21 leaves a ragged tail tile), and its dense
oracle. Values and gradients for one numpy cotangent agree within 1e-10.
The CUDA kernels themselves are held against the same plain versions on
the card by chip_smoke.py; here, the route to them (which of the two
kernel libraries a launch takes, by dtype and backward mode, and the
arguments it passes) runs against a recording stand-in library.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import helpers

ATOL = 1e-10
BLK = 8


def _data(B=2, H=4, Hk=4, T=21, D=8, seed=0, mask="none"):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, D) * 0.5
    k = rng.randn(B, Hk, T, D) * 0.5
    v = rng.randn(B, Hk, T, D) * 0.5
    do = rng.randn(B, H, T, D)
    m = None
    if mask != "none":
        m = (rng.rand(B, T) > 0.3).astype(np.float64)
        if mask == "full_row":          # batch 1 sees no key at all
            m[1] = 0.0
    return q, k, v, do, m


def _jax_vjp(q, k, v, m, do, causal, window, dlse=None):
    jm = None if m is None else jnp.asarray(m)
    if dlse is None:
        def f(q, k, v):
            return jfa.flash_attention(q, k, v, jm, causal, None, BLK, BLK,
                                       window)
        out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
        return out, None, vjp(jnp.asarray(do))

    def g(q, k, v):
        return jfa.flash_attention_lse(q, k, v, jm, causal, None, BLK, BLK,
                                       window)
    (out, lse), vjp = jax.vjp(g, *map(jnp.asarray, (q, k, v)))
    return out, lse, vjp((jnp.asarray(do), jnp.asarray(dlse)))


def _torch_vjp(q, k, v, m, do, causal, window, dlse=None, bwd=None):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tm = None if m is None else torch.from_numpy(m)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, tm, causal, None, window,
                                       bwd)
    outs, cots = [out], [torch.from_numpy(do)]
    if dlse is not None:
        outs.append(lse)
        cots.append(torch.from_numpy(dlse))
    grads = torch.autograd.grad(outs, (tq, tk, tv), cots)
    return out.detach(), lse.detach(), grads


CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "causal-window5": dict(causal=True, window=5),
    "noncausal-window3-mask": dict(causal=False, window=3, mask="random"),
    "causal-mask": dict(causal=True, mask="random"),
    "fully-masked-row": dict(causal=True, mask="full_row"),
    "T16-tile-multiple": dict(causal=True, T=16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_backward_match_jax_kernels(name):
    kw = dict(CASES[name])
    causal, window = kw.pop("causal"), kw.pop("window", 0)
    q, k, v, do, m = _data(mask=kw.pop("mask", "none"), **kw)
    jout, _, jg = _jax_vjp(q, k, v, m, do, causal, window)
    tout, _, tg = _torch_vjp(q, k, v, m, do, causal, window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    ref = jfa.flash_attention_reference(
        *map(jnp.asarray, (q, k, v)), None if m is None else jnp.asarray(m),
        causal, None, window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    if name == "fully-masked-row":
        assert np.all(tout.numpy()[1] == 0)
        for g in tg:
            assert np.all(g.numpy()[1] == 0)


def test_lse_variant_with_dlse_matches_jax():
    q, k, v, do, m = _data(mask="random", seed=3)
    dlse = np.random.RandomState(4).randn(2, 4, 21)
    jout, jlse, jg = _jax_vjp(q, k, v, m, do, True, 0, dlse)
    tout, tlse, tg = _torch_vjp(q, k, v, m, do, True, 0, dlse)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("hk", [1, 2])
def test_gqa_forward_matches_jax(hk):
    q, k, v, _, m = _data(Hk=hk, seed=5, mask="random")
    jm = jnp.asarray(m)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), jm, True, None,
                              BLK, BLK)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(m), True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    dense = tfa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                          torch.from_numpy(m), True)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL, rtol=0)


def test_gqa_backward_raises():
    q, k, v, do, _ = _data(Hk=2)
    with pytest.raises(NotImplementedError, match="grouped"):
        _torch_vjp(q, k, v, None, do, True, 0)
    with pytest.raises(NotImplementedError, match="grouped"):
        tfa.flash_bwd_plain(*map(torch.from_numpy, (q, k, v)), None,
                            torch.zeros(2, 4, 21, 8), torch.zeros(2, 4, 21),
                            torch.from_numpy(do))


@pytest.mark.parametrize("window,mask", [(0, "none"), (4, "random")])
def test_fused_equals_two_pass(window, mask):
    q, k, v, do, m = _data(seed=7, mask=mask)
    _, _, a = _torch_vjp(q, k, v, m, do, True, window, bwd="fused")
    _, _, b = _torch_vjp(q, k, v, m, do, True, window, bwd="two_pass")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_configure_env_knob_and_dq_partials():
    prev = tfa.configure(bwd="two_pass")
    try:
        assert prev[0] in tfa.BWD_MODES and prev[1] == "acc"
        assert tfa._resolve_bwd(None) == "two_pass"
        assert tfa.configure() == ("two_pass", "acc")
        with pytest.raises(ValueError):
            tfa.configure(bwd="three_pass")
        with pytest.raises(NotImplementedError, match="dq_partials"):
            tfa.configure(dq_partials="io")
        q, k, v, _, _ = _data()
        with pytest.raises(NotImplementedError, match="dq_partials"):
            tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                dq_partials="io")
    finally:
        tfa.configure(bwd=prev[0])


def test_env_knob_sets_default(monkeypatch):
    import importlib
    monkeypatch.setenv("DL4J_TPU_FLASH_BWD", "two_pass")
    mod = importlib.reload(tfa)
    try:
        assert mod._resolve_bwd(None) == "two_pass"
    finally:
        monkeypatch.delenv("DL4J_TPU_FLASH_BWD")
        importlib.reload(tfa)
    assert tfa._resolve_bwd(None) == "fused"


def test_seam_routes_by_device():
    """CPU tensors take the plain versions; the CUDA wrappers are what is
    registered, and they refuse CPU tensors rather than fall back."""
    x = torch.zeros(1)
    assert helpers.helper_for("flash_attention_fwd", tfa.flash_fwd_plain,
                              x) is tfa.flash_fwd_plain
    reg = helpers.registered_helpers()
    assert reg["flash_attention_fwd"] is tfa.flash_attention_fwd_cuda
    assert reg["flash_attention_bwd"] is tfa.flash_attention_bwd_cuda
    q, k, v, do, _ = _data()
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd_cuda(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(tq, tk, tv, None, tq, tq[..., 0],
                                     torch.from_numpy(do))


@pytest.mark.parametrize("D,Dp", [(8, 16), (20, 32), (48, 64)])
def test_head_dim_padding_is_exact(D, Dp):
    """The CUDA wrappers' head-dim padding around the plain versions
    equals the plain versions at the true D (scale 1/sqrt of the true D),
    forward and backward."""
    assert tfa._kernel_head_dim(D) == Dp
    q, k, v, do, m = _data(D=D, seed=4, mask="random")
    q, k, v, do, m = (torch.from_numpy(a) for a in (q, k, v, do, m))
    o, lse = tfa.flash_fwd_plain(q, k, v, m, True, None, 5)
    po, plse = tfa.padded_fwd(tfa.flash_fwd_plain, q, k, v, m, True, None,
                              5)
    assert po.shape == o.shape
    torch.testing.assert_close(po, o, rtol=0, atol=ATOL)
    torch.testing.assert_close(plse, lse, rtol=0, atol=ATOL)
    dlse = torch.ones_like(lse) * 0.1
    ref = tfa.flash_bwd_plain(q, k, v, m, o, lse, do, dlse, True, None, 5)
    got = tfa.padded_bwd(tfa.flash_bwd_plain, q, k, v, m, o, lse, do, dlse,
                         True, None, 5)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0, atol=ATOL)
    # above 512 the kernel head dim is the next multiple of 128
    assert tfa._kernel_head_dim(513) == 640


# ------------------------------------------------ the route to the kernels
@pytest.mark.parametrize("dtype,kind,source", [
    (torch.bfloat16, "fwd", tfa.SM90_SOURCE),
    (torch.bfloat16, "two_pass", tfa.SM90_SOURCE),
    (torch.bfloat16, "fused", tfa.SM90_SOURCE),
    (torch.float32, "fwd", tfa.SOURCE),
    (torch.float32, "two_pass", tfa.SOURCE),
    (torch.float32, "fused", tfa.SOURCE),
])
def test_route_by_dtype_and_mode(dtype, kind, source):
    """bf16 K3, K4 and K5 take the wgmma kernels (up to D 128); fp32 the
    others."""
    assert tfa._route(dtype, kind, 16) == source
    assert source in tfa.SOURCES
    with pytest.raises(ValueError):
        tfa._route(dtype, "three_pass", 16)


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
    """Stands for both kernel libraries: records each launch."""
    NAMES = ("dl4j_flash_fwd", "dl4j_flash_bwd", "dl4j_flash_error_string",
             "dl4j_flash_sm90_fwd", "dl4j_flash_sm90_bwd",
             "dl4j_flash_sm90_bwd_fused", "dl4j_flash_sm90_smem",
             "dl4j_flash_sm90_error_string")

    def __init__(self, err=0):
        self.log = []
        for n in self.NAMES:
            setattr(self, n, _FakeFn(n, self.log, err))


@pytest.fixture
def fake_lib(monkeypatch):
    """The real `_library` set-up on a fake library, and a fake stream, so
    that the launch code runs on CPU tensors."""
    from types import SimpleNamespace
    libs = {}

    def load(source):
        return libs.setdefault(source, _FakeLib())
    monkeypatch.setattr(tfa.build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=77))
    return libs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_launch_reaches_its_kernel(fake_lib, dtype):
    q, k, v, _, m = (torch.from_numpy(a).to(dtype) for a in
                     _data(B=2, H=4, Hk=2, T=21, D=16, mask="random"))
    before = tfa.flash_attention_fwd_cuda.launches
    o, lse = tfa._fwd_launch(q, k, v, m, True, 0.25, 5)
    assert tfa.flash_attention_fwd_cuda.launches == before + 1
    assert o.shape == q.shape and o.dtype == dtype
    assert lse.shape == (2, 4, 21) and lse.dtype == torch.float32
    source = tfa._route(dtype, "fwd", 16)
    lib = fake_lib[source]
    ((name, args),) = lib.log
    fn = getattr(lib, name)
    assert len(args) == len(fn.argtypes)
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        args[3], o.data_ptr(), lse.data_ptr())
    assert args[6:13] == (2, 4, 2, 21, 16, 1, 5)
    assert args[-1] == 77 and args[-2] == 0.25
    if dtype == torch.bfloat16:
        assert name == "dl4j_flash_sm90_fwd"
    else:
        assert name == "dl4j_flash_fwd" and args[13] == 0


@pytest.mark.parametrize("dtype,mode", [(torch.bfloat16, "two_pass"),
                                        (torch.bfloat16, "fused"),
                                        (torch.float32, "two_pass")])
def test_backward_launch_reaches_its_kernel(fake_lib, dtype, mode):
    q, k, v, do, m = (torch.from_numpy(a).to(dtype) for a in
                      _data(T=21, D=16, mask="random"))
    o = torch.zeros_like(q)
    lse = torch.zeros(2, 4, 21)
    counts = (tfa.flash_attention_bwd_cuda.fused_launches,
              tfa.flash_attention_bwd_cuda.two_pass_launches)
    dq, dk, dv = tfa._bwd_launch(q, k, v, m, o, lse, do, None, False, 0.5,
                                 0, mode)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    two = mode == "two_pass"
    assert (tfa.flash_attention_bwd_cuda.fused_launches,
            tfa.flash_attention_bwd_cuda.two_pass_launches) == (
        counts[0] + (not two), counts[1] + 2 * two)
    lib = fake_lib[tfa._route(dtype, mode, 16)]
    ((name, args),) = lib.log
    assert len(args) == len(getattr(lib, name).argtypes)
    assert args[10:16] == (2, 4, 21, 16, 0, 0)
    assert args[-1] == 77 and args[-2] == 0.5
    if tfa._route(dtype, mode, 16) == tfa.SM90_SOURCE:
        assert name == ("dl4j_flash_sm90_bwd" if two
                        else "dl4j_flash_sm90_bwd_fused")
    else:
        assert name == "dl4j_flash_bwd"
        assert args[16:18] == (tfa._DTYPE_CODE[dtype], int(two))


def test_failed_launch_raises_with_its_library_error(monkeypatch):
    from types import SimpleNamespace
    lib = _FakeLib(err=1002)
    monkeypatch.setattr(tfa.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _data(D=16)[:3])
    with pytest.raises(RuntimeError,
                       match="error 1002 from dl4j_flash_sm90_error_string"):
        tfa._fwd_launch(q, k, v, None, True, None, 0)


def test_fused_bf16_launch_reaches_the_wgmma_kernel(fake_lib):
    """bf16 K4 is one call of the sm90 library's fused entry point: every
    argument against its argtypes (10 pointers: the zeroed fp32 dq buffer
    among them, then B, H, T, D, causal, window, the scale and the
    stream), one fused launch counted and no two-pass one."""
    import ctypes
    q, k, v, do, m = (torch.from_numpy(a).to(torch.bfloat16) for a in
                      _data(B=2, H=4, Hk=4, T=21, D=16, mask="random"))
    o = torch.zeros_like(q)
    lse = torch.zeros(2, 4, 21)
    counts = (tfa.flash_attention_bwd_cuda.fused_launches,
              tfa.flash_attention_bwd_cuda.two_pass_launches)
    dq, dk, dv = tfa._bwd_launch(q, k, v, m, o, lse, do, None, True, 0.25,
                                 7, "fused")
    assert (tfa.flash_attention_bwd_cuda.fused_launches,
            tfa.flash_attention_bwd_cuda.two_pass_launches) == (
        counts[0] + 1, counts[1])
    lib = fake_lib[tfa.SM90_SOURCE]
    assert tfa.SOURCE not in fake_lib
    ((name, args),) = lib.log
    assert name == "dl4j_flash_sm90_bwd_fused"
    fn = lib.dl4j_flash_sm90_bwd_fused
    assert fn.argtypes == [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert len(args) == len(fn.argtypes)
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3] is not None and args[4] == do.data_ptr()
    assert all(isinstance(a, int) for a in args[5:10])
    assert args[10:16] == (2, 4, 21, 16, 1, 7)
    assert args[-2] == 0.25 and args[-1] == 77
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert torch.equal(dq, torch.zeros_like(dq))   # the stand-in adds nothing


def test_failed_fused_launch_raises_and_counts_nothing(monkeypatch):
    from types import SimpleNamespace
    lib = _FakeLib(err=700)
    monkeypatch.setattr(tfa.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _data(D=16)[:4])
    before = tfa.flash_attention_bwd_cuda.fused_launches
    with pytest.raises(RuntimeError, match=r"flash_attention_bwd \(fused\) "
                       "launch failed: error 700 from "
                       "dl4j_flash_sm90_error_string"):
        tfa._bwd_launch(q, k, v, None, torch.zeros_like(q),
                        torch.zeros(q.shape[:3]), do, None, True, None, 0,
                        "fused")
    assert tfa.flash_attention_bwd_cuda.fused_launches == before
    assert [n for n, _ in lib.log] == ["dl4j_flash_sm90_bwd_fused"]
