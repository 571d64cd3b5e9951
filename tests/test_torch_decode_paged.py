"""The port's paged decode (K1, K2) at its kernel's partition plan against
the JAX package's, in float64 on the CPU.

K1/K2's kernel (csrc/flash_decode_paged.cu) cuts each slot's block table
into partitions of `paged_partition` whole blocks, one CTA each, and merges
the normalized partials by logaddexp in the same launch. Here the plain
version of that split, `paged_partials_plain`, at the kernel's own plan and
merged by `merge_partials`, must equal the JAX package's
`flash_decode_attention_paged` and `flash_decode_attention_spec_paged`
(their Pallas kernels in interpret mode, as tests/test_decode_attention.py
runs them, under one jax.jit per shape) and the dense oracles to 1e-10:
block sizes 8, 16 and 12 (which the plan of 5 blocks splits unevenly over
12 blocks), GQA groups 1/2/4, windows 0/5, the int8 pool with its scales,
visible lengths 1, L and one drawn, shuffled block tables with trash
entries. Row i of the plain K2 split is the plain K1 split at visible + i.
The launch itself runs against a recording stand-in library: the function,
its arguments against its argtypes, one launch a call, the ticket buffer,
the merge-off partials and a failed launch. The kernel is held against the
same plain versions on the card by chip_smoke.py.
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.decode_attention import (
    decode_attention_dense_paged as jax_dense,
    decode_attention_dense_spec_paged as jax_dense_spec,
    flash_decode_attention_paged as jax_flash,
    flash_decode_attention_spec_paged as jax_flash_spec)
from deeplearning4j_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

ATOL = 1e-10
S, HK, D, BPS = 3, 2, 8, 12


def _case(Q, G, bs, window, quant, seed):
    """q (S, Q, H, D) (Q None: K1's (S, H, D)), a pool of S * BPS + 2
    blocks and the trash block, each slot's visible blocks on a shuffled
    set of physical blocks and the rest of its row on the trash block."""
    rng = np.random.RandomState(seed)
    extra = 0 if Q is None else Q - 1
    L, nb = BPS * bs, S * BPS + 2
    vis = np.asarray([1, L - extra, rng.randint(2, L - extra)], np.int32)
    perm = rng.permutation(nb)
    bt = np.full((S, BPS), nb, np.int32)
    used = 0
    for s in range(S):
        n = -(-(int(vis[s]) + extra) // bs)
        bt[s, :n] = perm[used:used + n]
        used += n
    q = rng.randn(*((S, HK * G, D) if Q is None else (S, Q, HK * G, D)))
    shape = (nb + 1, bs, HK, D)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        scales = {"k_scale": rng.uniform(1e-3, 2e-2, (nb + 1, HK)),
                  "v_scale": rng.uniform(1e-3, 2e-2, (nb + 1, HK))}
    else:
        kp, vp, scales = rng.randn(*shape), rng.randn(*shape), {}
    return [q, kp, vp, bt, vis], scales


def _torch(arrays, scales):
    return ([torch.from_numpy(a) for a in arrays],
            {k: torch.from_numpy(v) for k, v in scales.items()})


@pytest.fixture(scope="module")
def jax_paged():
    """The JAX kernels and dense oracles, each under one jax.jit for the
    module (scale and window static): a case compiles one program instead
    of dispatching every op of the interpreted kernel."""
    return {name: jax.jit(fn, static_argnums=(5, 6)) for name, fn in (
        ("k1", jax_flash), ("dense", jax_dense), ("k2", jax_flash_spec),
        ("dense_spec", jax_dense_spec))}


def _plan(bs, kv_elt=8):
    return tda.paged_partition(bs, D, 8, kv_elt)


K1_CASES = [(8, 1, 0, False), (8, 2, 5, False), (8, 4, 0, True),
            (12, 2, 0, False), (12, 4, 5, False), (12, 1, 0, True),
            (16, 1, 5, False), (16, 4, 0, False), (16, 2, 5, True)]


@pytest.mark.parametrize("bs,G,window,quant", K1_CASES)
def test_k1_split_at_plan_matches_jax_flash_and_dense(jax_paged, bs, G,
                                                      window, quant):
    arrays, scales = _case(None, G, bs, window, quant, seed=bs + 10 * G)
    targs, tsc = _torch(arrays, scales)
    bpp = _plan(bs, 1 if quant else 8)
    assert bpp == {8: 8, 12: 5, 16: 4}[bs]
    o_p, l_p = tda.paged_partials_plain(*targs, 0.3, window, plan=bpp, **tsc)
    n = -(-BPS // bpp)
    assert o_p.shape == (S, HK, n, 1, G, D) and l_p.shape == (S, HK, n, 1, G)
    # partitions no position of the slot falls in are (0, NEG_INF)
    for s, v in enumerate(arrays[4]):
        lo = max(0, v - window) if window else 0
        busy = [j * bpp * bs < v and (j + 1) * bpp * bs > lo
                for j in range(n)]
        assert [bool((l_p[s, :, j] > -1e29).all()) for j in range(n)] == busy
        assert torch.all(o_p[s, :, [j for j in range(n) if not busy[j]]] == 0)
    out = tda.merge_partials(o_p, l_p, torch.float64)[:, 0]
    jargs = [jnp.asarray(a) for a in arrays]
    jsc = {k: jnp.asarray(v) for k, v in scales.items()}
    for ref in (jax_paged["k1"](*jargs, 0.3, window, **jsc),
                jax_paged["dense"](*jargs, 0.3, window, **jsc)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    # one block a partition gives the same values: the merge makes them
    # independent of the plan
    o1, l1 = tda.paged_partials_plain(*targs, 0.3, window, plan=1, **tsc)
    np.testing.assert_allclose(
        tda.merge_partials(o1, l1, torch.float64)[:, 0].numpy(), out.numpy(),
        atol=ATOL, rtol=0)


K2_CASES = [(2, 8, 2, 0, False), (2, 12, 1, 5, False), (2, 16, 4, 5, True),
            (5, 8, 4, 5, False), (5, 12, 2, 0, True), (5, 16, 1, 0, False)]


@pytest.mark.parametrize("Q,bs,G,window,quant", K2_CASES)
def test_k2_split_at_plan_matches_jax_flash_and_k1_rows(jax_paged, Q, bs, G,
                                                        window, quant):
    arrays, scales = _case(Q, G, bs, window, quant, seed=Q + bs + G)
    (q, kp, vp, bt, vis), tsc = _torch(arrays, scales)
    bpp = _plan(bs, 1 if quant else 8)
    o_p, l_p = tda.paged_partials_plain(q, kp, vp, bt, vis, 0.3, window,
                                        plan=bpp, **tsc)
    out = tda.merge_partials(o_p, l_p, torch.float64)
    assert out.shape == q.shape
    jargs = [jnp.asarray(a) for a in arrays]
    jsc = {k: jnp.asarray(v) for k, v in scales.items()}
    for ref in (jax_paged["k2"](*jargs, 0.3, window, **jsc),
                jax_paged["dense_spec"](*jargs, 0.3, window, **jsc)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    # row i of the split is K1's split at visible + i, partition by
    # partition: the plan does not depend on Q
    for i in range(Q):
        o1, l1 = tda.paged_partials_plain(q[:, i], kp, vp, bt, vis + i, 0.3,
                                          window, plan=bpp, **tsc)
        assert torch.equal(o1[:, :, :, 0], o_p[:, :, :, i])
        assert torch.equal(l1[:, :, :, 0], l_p[:, :, :, i])


# what chip_smoke.py sweeps: head dims 64 and 128, block sizes 8/16/32, the
# fp32, bf16 and int8 pools with fp32 and bf16 queries; the served shape is
# bs 16, D 64
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("Dh", [64, 128])
def test_plan_fits_shared_memory_at_the_swept_shapes(bs, Dh):
    for q_elt, kv_elt in ((4, 4), (2, 2), (4, 1), (2, 1)):
        bpp = tda.paged_partition(bs, Dh, q_elt, kv_elt)
        assert bpp == tda.PARTITION // bs
        assert tda.paged_smem_bytes(bs, bpp, Dh, q_elt, kv_elt) \
            <= tda.SMEM_LIMIT == 232448


def test_plan_halves_until_it_fits_and_raises_beyond_one_block():
    assert tda.paged_smem_bytes(16, 4, 64, 2, 2) == 27584
    assert [tda.paged_partition(bs, 64, 2, 2)
            for bs in (1, 8, 12, 16, 32, 64, 128)] == [64, 8, 5, 4, 2, 1, 1]
    assert [tda.paged_partition(16, d, 4, 4)
            for d in (64, 256, 512, 1024)] == [4, 4, 2, 1]
    for d in (512, 1024):
        bpp = tda.paged_partition(16, d, 4, 4)
        assert tda.paged_smem_bytes(16, bpp, d, 4, 4) <= tda.SMEM_LIMIT
        assert tda.paged_smem_bytes(16, 2 * bpp, d, 4, 4) > tda.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tda.paged_partition(32, 1024, 4, 4)


class _FakeFn:
    def __init__(self, name, lib):
        self.name, self.lib = name, lib
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        if self.name == "dl4j_capture_id":
            return self.lib.capture
        self.lib.log.append((self.name, args))
        return self.lib.err


class _FakeLib:
    NAMES = ("dl4j_flash_decode_paged", "dl4j_flash_decode_paged_smem",
             "dl4j_cuda_error_string", "dl4j_capture_id")

    def __init__(self, err=0):
        self.log, self.err, self.capture = [], err, 0
        for n in self.NAMES:
            setattr(self, n, _FakeFn(n, self))


@pytest.fixture
def fake_lib(monkeypatch):
    """The real `_library` set-up on a stand-in library and a stand-in
    stream, so that the launch code runs on CPU tensors; the launch
    counters are restored afterwards."""
    lib = _FakeLib()
    monkeypatch.setattr(tda.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=91))
    monkeypatch.setattr(tda, "_TICKETS", {})
    for fn in (tda.flash_decode_attention_paged,
               tda.flash_decode_attention_spec_paged):
        monkeypatch.setattr(fn, "launches", fn.launches)
    return lib


def _bf16(Q, quant=False):
    (q, kp, vp, bt, vis), sc = _torch(*_case(Q, 2, 16, 5, quant, seed=4))
    q = q.to(torch.bfloat16)
    if not quant:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    else:
        sc = {k: v.float() for k, v in sc.items()}
    return (q, kp, vp, bt, vis, 0.3, 5), sc


@pytest.mark.parametrize("Q", [None, 5])
@pytest.mark.parametrize("merge", [True, False])
def test_launch_reaches_its_kernel_once_a_call(fake_lib, Q, merge):
    args, sc = _bf16(Q, quant=Q is None)
    q, kp = args[0], args[1]
    fn = tda.flash_decode_attention_paged if Q is None \
        else tda.flash_decode_attention_spec_paged
    before = fn.launches
    got = tda._launch(*args, sc.get("k_scale"), sc.get("v_scale"), merge, fn)
    assert fn.launches == before + 1
    ((name, cargs),) = fake_lib.log
    cfn = fake_lib.dl4j_flash_decode_paged
    assert name == "dl4j_flash_decode_paged"
    assert cfn.argtypes == [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [
        ctypes.c_float, ctypes.c_void_p]
    assert len(cargs) == len(cfn.argtypes)
    assert cargs[:3] == (q.data_ptr(), kp.data_ptr(), args[2].data_ptr())
    assert (cargs[3] is None) == (Q is not None)
    nq, kv_code = (1, 3) if Q is None else (Q, 2)
    bpp = tda.paged_partition(16, D, 2, kp.element_size())
    assert cargs[11:23] == (S, nq, HK, 2, D, 16, BPS, bpp, 5, int(merge), 2,
                            kv_code)
    assert cargs[-2] == pytest.approx(0.3) and cargs[-1] == 91
    tickets = tda._TICKETS[(q.device, 91, 0)][-1]
    assert cargs[9] == tickets.data_ptr() and tickets.numel() >= S * HK
    assert torch.all(tickets == 0)
    n = -(-BPS // bpp)
    if merge:
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        assert cargs[10] == got.data_ptr()
    else:
        o_p, l_p = got
        assert o_p.shape == (S, HK, n, nq, 2, D) and o_p.dtype == torch.float32
        assert l_p.shape == (S, HK, n, nq, 2)
        assert (cargs[7], cargs[8]) == (o_p.data_ptr(), l_p.data_ptr())
        assert cargs[10] is None


def test_tickets_per_stream_and_per_capture(fake_lib):
    args = _bf16(None)[0]
    k1, k2 = tda.flash_decode_attention_paged, \
        tda.flash_decode_attention_spec_paged
    tda._launch(*args, None, None, True, k1)
    tda._launch(*args, None, None, False, k1)
    first, second = (a[9] for _, a in fake_lib.log)
    assert first == second                   # reused across calls
    fake_lib.capture = 7                     # a CUDA graph capture
    tda._launch(*_bf16(3)[0], None, None, True, k2)
    captured = fake_lib.log[-1][1][9]
    assert captured != first
    assert set(tda._TICKETS) == {(args[0].device, 91, 0),
                                 (args[0].device, 91, 7)}
    assert all(torch.all(b[-1] == 0) for b in tda._TICKETS.values())


def test_failed_launch_raises_and_cpu_partials_refused(monkeypatch):
    lib = _FakeLib(err=700)
    monkeypatch.setattr(tda.build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tda, "_TICKETS", {})
    args = _bf16(None)[0]
    k1 = tda.flash_decode_attention_paged
    before = k1.launches
    with pytest.raises(RuntimeError, match="flash_decode_attention_paged "
                       "launch failed: error 700 from "
                       "dl4j_cuda_error_string"):
        tda._launch(*args, None, None, True, k1)
    assert k1.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tda.flash_decode_partials(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tda.flash_decode_spec_partials(*_bf16(3)[0])
    q, kp, vp = args[:3]
    with pytest.raises(TypeError, match="must match"):
        tda._launch(q, kp.half(), vp, *args[3:], None, None, True, k1)
    with pytest.raises(TypeError, match="int8 pool"):
        tda._launch(*args, torch.ones(S * BPS + 3, HK), None, True, k1)
    assert k1.launches == before
