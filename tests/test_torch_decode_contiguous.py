"""The port's split-K decode over a contiguous cache (K6) against the JAX
package's, in float64 on the CPU.

K6's kernel (csrc/flash_decode_contiguous.cu) cuts each slot's cache into
partitions of `contiguous_partition` positions, one CTA each, and merges
the normalized partials by logaddexp in the same launch. Here the plain
version of that split, `contiguous_partials_plain`, at the kernel's own
plan and merged by `merge_partials`, must equal the JAX package's
`flash_decode_attention` (its Pallas kernel in interpret mode, as
tests/test_decode_attention.py runs it, under one jax.jit per shape) and
the dense oracle to 1e-10:
cache lengths 300 (a ragged last partition) and 1024, GQA groups 1/2/4,
windows 0/5, visible lengths 1, L and one drawn. The launch itself runs
against a recording stand-in library: the function, its arguments against
its argtypes, the ticket buffer, the launch counter and a failed launch.
The kernel is held against the same plain versions on the card by
chip_smoke.py.
"""
import ctypes
import math
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.decode_attention import (
    decode_attention_dense as jax_dense,
    flash_decode_attention as jax_flash)
from deeplearning4j_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

ATOL = 1e-10
S, HK, D = 3, 2, 8
# the JAX partition for each L: its Pallas kernel, not its dense fallback
JAX_BKV = {300: 100, 1024: 256}


def _case(L, G, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, HK * G, D)
    kc, vc = rng.randn(S, L, HK, D), rng.randn(S, L, HK, D)
    vis = np.asarray([1, L, rng.randint(2, L)], np.int32)
    return q, kc, vc, vis


@pytest.fixture(scope="module")
def jax_k6():
    """The JAX kernel and dense oracle, each under one jax.jit for the
    module (scale, window and the partition static): a case compiles one
    program instead of dispatching every op of the interpreted kernel."""
    return (jax.jit(jax_flash, static_argnums=(4, 5),
                    static_argnames=("bkv",)),
            jax.jit(jax_dense, static_argnums=(4, 5)))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("L", [300, 1024])
def test_split_merge_plan_matches_jax_flash_and_dense(jax_k6, L, G, window):
    jax_flash, jax_dense = jax_k6
    q, kc, vc, vis = _case(L, G, seed=L + 10 * G + window)
    targs = [torch.from_numpy(a) for a in (q, kc, vc, vis)]
    P = tda.contiguous_partition(G, D, 8)
    assert P == tda.PARTITION == 64
    o_p, l_p = tda.contiguous_partials_plain(*targs, 0.3, window, P)
    n = math.ceil(L / P)
    assert o_p.shape == (S, HK, n, G, D) and l_p.shape == (S, HK, n, G)
    # partitions with no visible position are (0, NEG_INF); the others
    # hold a finite L_p
    for s, v in enumerate(vis):
        lo = max(0, v - window) if window else 0
        busy = [lo // P <= j < math.ceil(v / P) for j in range(n)]
        assert [bool((l_p[s, :, j] > -1e29).all()) for j in range(n)] == busy
        idle = [j for j in range(n) if not busy[j]]
        assert torch.all(o_p[s, :, idle] == 0)
    out = tda.merge_partials(o_p[:, :, :, None], l_p[:, :, :, None],
                             torch.float64)[:, 0]
    jargs = [jnp.asarray(a) for a in (q, kc, vc, vis)]
    ref = np.asarray(jax_flash(*jargs, 0.3, window, bkv=JAX_BKV[L]))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_dense(*jargs, 0.3, window)),
                               atol=ATOL, rtol=0)
    # another partition gives the same values: the merge makes them
    # independent of the plan
    o16, l16 = tda.contiguous_partials_plain(*targs, 0.3, window, 16)
    out16 = tda.merge_partials(o16[:, :, :, None], l16[:, :, :, None],
                               torch.float64)[:, 0]
    np.testing.assert_allclose(out16.numpy(), ref, atol=ATOL, rtol=0)


class _FakeFn:
    def __init__(self, name, log, err):
        self.name, self.log, self.err = name, log, err
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        if self.name == "dl4j_capture_id":
            return 0
        self.log.append((self.name, args))
        return self.err


class _FakeLib:
    NAMES = ("dl4j_flash_decode_contiguous",
             "dl4j_flash_decode_contiguous_smem",
             "dl4j_flash_decode_contiguous_error_string", "dl4j_capture_id")

    def __init__(self, err=0):
        self.log = []
        for n in self.NAMES:
            setattr(self, n, _FakeFn(n, self.log, err))


@pytest.fixture
def fake_lib(monkeypatch):
    """The real `_contiguous_library` set-up on a stand-in library and a
    stand-in stream, so that the launch code runs on CPU tensors."""
    lib = _FakeLib()
    monkeypatch.setattr(tda.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=91))
    monkeypatch.setattr(tda, "_TICKETS", {})
    return lib


@pytest.mark.parametrize("merge", [True, False])
def test_k6_launch_reaches_its_kernel(fake_lib, merge):
    q, kc, vc, vis = (torch.from_numpy(a) for a in _case(300, 2, seed=1))
    q, kc, vc = (t.to(torch.bfloat16) for t in (q, kc, vc))
    before = tda.flash_decode_attention.launches
    got = tda._contiguous_launch(q, kc, vc, vis, 0.3, 5, merge)
    assert tda.flash_decode_attention.launches == before + 1
    ((name, args),) = fake_lib.log
    fn = fake_lib.dl4j_flash_decode_contiguous
    assert name == "dl4j_flash_decode_contiguous"
    assert fn.argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    assert len(args) == len(fn.argtypes)
    assert args[:3] == (q.data_ptr(), kc.data_ptr(), vc.data_ptr())
    P = tda.contiguous_partition(2, D, 2)
    assert args[8:17] == (S, 300, HK, 2, D, P, 5, int(merge), 2)
    assert args[-2] == 0.3 and args[-1] == 91
    tickets = tda._TICKETS[(q.device, 91, 0)][-1]
    assert args[6] == tickets.data_ptr() and tickets.numel() >= S * HK
    assert torch.all(tickets == 0)
    if merge:
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        assert args[7] == got.data_ptr()
    else:
        o_p, l_p = got
        n = math.ceil(300 / P)
        assert o_p.shape == (S, HK, n, 2, D) and l_p.shape == (S, HK, n, 2)
        assert (args[4], args[5]) == (o_p.data_ptr(), l_p.data_ptr())
    # a second call on the stream reuses its tickets
    tda._contiguous_launch(q, kc, vc, vis, 0.3, 5, merge)
    assert fake_lib.log[-1][1][6] == tickets.data_ptr()


def test_k6_failed_launch_raises_and_cpu_partials_refused(monkeypatch):
    lib = _FakeLib(err=700)
    monkeypatch.setattr(tda.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tda, "_TICKETS", {})
    q, kc, vc, vis = (torch.from_numpy(a) for a in _case(300, 1, seed=2))
    q, kc, vc = (t.float() for t in (q, kc, vc))
    before = tda.flash_decode_attention.launches
    with pytest.raises(RuntimeError, match="error 700 from "
                       "dl4j_flash_decode_contiguous_error_string"):
        tda._contiguous_launch(q, kc, vc, vis, 0.3, 0, True)
    assert tda.flash_decode_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tda.flash_decode_contiguous_partials(q, kc, vc, vis, 0.3)
    with pytest.raises(TypeError, match="must match"):
        tda._contiguous_launch(q, kc.half(), vc, vis, 0.3, 0, True)
