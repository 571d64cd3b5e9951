"""K7's backward on the card, as far as the CPU can reach it.

K7's backward has two sweep kernels, chosen by `scan_bwd_variant(H,
dtype)` before the launch: the cluster sweep of lstm_scan_bwd_sm90.cu
(bf16 at a padded H of 64, 128 or 256) and lstm_scan.cu's tile sweep
(every other H, and fp32). In bf16 either sweep is followed by the wgmma
dRW kernel, whose per-chunk fp32 partials `reduce_drw_partials` sums in a
fixed order; fp32 keeps lstm_scan.cu's dRW. Here: the rule over (H,
dtype) pairs; each variant's launch against a recording stand-in library
(argtypes, arguments, the partial buffers' shapes, the per-variant
counters); a failed launch of either kernel raises and counts nothing;
the chunk sum against a plain sum; and the plain backward at the cluster
widths against the JAX package's Pallas kernel (interpret mode, compiled
once by `jax.jit` through a module fixture) in float64, tolerance 1e-10.
The kernels themselves are held against the plain version on the card by
chip_smoke.py.
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.lstm_scan_fused import graves_lstm_scan_pallas
from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

TOL = 1e-10
NAMES = ("dxw", "drw", "dpi", "dpf", "dpo", "dh0", "dc0")


@pytest.mark.parametrize("H,dtype,variant", [
    (64, torch.bfloat16, "cluster"), (128, torch.bfloat16, "cluster"),
    (256, torch.bfloat16, "cluster"), (250, torch.bfloat16, "cluster"),
    (120, torch.bfloat16, "cluster"), (50, torch.bfloat16, "cluster"),
    (32, torch.bfloat16, "tile"), (200, torch.bfloat16, "tile"),
    (512, torch.bfloat16, "tile"), (1072, torch.bfloat16, "tile"),
    (256, torch.float32, "tile"), (64, torch.float32, "tile"),
    (128, torch.float32, "tile")])
def test_scan_bwd_variant_rule(H, dtype, variant):
    """The cluster sweep keeps the RW slice of H / 8 units (8 H^2 / 8
    bytes) and 16 fp32 receive slots of 64 rows x H / 8 units in each CTA,
    196 KB at H 256: bf16 at a padded H of 64, 128 or 256, as the
    forward's rule; everything else takes the tile sweep."""
    assert ts.scan_bwd_variant(H, dtype) == variant
    assert ts.scan_bwd_variant(H, dtype) == ts.scan_fwd_variant(H, dtype)
    if variant == "cluster":
        Hp = -(-H // 16) * 16
        U = Hp // 8
        assert Hp in ts.CLUSTER_FWD_H and U % 8 == 0
        assert Hp * 4 * U * 2 + 2 * 8 * 64 * U * 4 <= 232448


def _tile_rows(H, dtype, bwd):
    """lstm_scan.cu `pick_bt` for the backward (bf16 and fp32)."""
    if H <= 0 or H % 16 or dtype not in (0, 2):
        return 0
    tc = dtype == 2
    elt, stage = (2, 4 * 8 * 4 * 256) if tc else (4, 0)
    ldh, ldg = (H + 8, 4 * H + 8) if tc else (H, 4 * H)
    bt = 64
    while bt >= (16 if tc else 8):
        owners = 2 if tc else bt // 8
        if stage + 12 * owners * H + elt * (bt * ldh + bt * ldg) <= 232448:
            return bt
        bt //= 2
    return 0


class _FakeFn:
    def __init__(self, name, log, ret):
        self.name, self.log, self.ret = name, log, ret
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        self.log.append((self.name, args))
        return self.ret(*args) if callable(self.ret) else self.ret


class _FakeLib:
    """Stands for lstm_scan.cu's and lstm_scan_bwd_sm90.cu's libraries;
    `fail` names the launch that returns `err`."""
    CHUNKS = 3

    def __init__(self, fail=None, err=0):
        self.log = []
        names = {"dl4j_lstm_scan_fwd": 0, "dl4j_lstm_scan_bwd": 0,
                 "dl4j_lstm_scan_tile": _tile_rows,
                 "dl4j_lstm_scan_error_string": None,
                 "dl4j_lstm_scan_bwd_cluster": 0,
                 "dl4j_lstm_drw_sm90": 0,
                 "dl4j_lstm_drw_chunks": self.CHUNKS,
                 "dl4j_lstm_scan_bwd_clusters": 15,
                 "dl4j_lstm_scan_bwd_cluster_smem": 200736,
                 "dl4j_lstm_scan_bwd_error_string": None}
        for n, ret in names.items():
            setattr(self, n, _FakeFn(n, self.log, err if n == fail else ret))


@pytest.fixture
def fake_lib(monkeypatch):
    """The real `_library` / `_bwd_library` set-up on one stand-in library
    and a stand-in stream, so that the launch code runs on CPU tensors;
    the launch counters are restored afterwards (other files' CPU tests
    check that no kernel launched)."""
    libs = {}
    bwd = ts.graves_lstm_scan_bwd_cuda
    monkeypatch.setattr(bwd, "launches", bwd.launches)
    monkeypatch.setattr(bwd, "variant_launches", dict(bwd.variant_launches))

    def install(fail=None, err=0):
        libs["lib"] = _FakeLib(fail, err)
        monkeypatch.setattr(ts.build, "load", lambda source: libs["lib"])
        monkeypatch.setattr(
            torch.cuda, "current_stream",
            lambda device=None: SimpleNamespace(cuda_stream=61))
        return libs["lib"]
    return install


def _inputs(H, dtype, T=3, B=5):
    rng = np.random.RandomState(H)
    shapes = [(T, B, 4 * H), (H, 4 * H), (H,), (H,), (H,), (B, H), (B, H),
              (T, B, H), (T, B, H), (T, B, H), (T, B, H)]
    return [torch.from_numpy(rng.randn(*s)).to(dtype) for s in shapes]


def _counts():
    return (ts.graves_lstm_scan_bwd_cuda.launches,
            dict(ts.graves_lstm_scan_bwd_cuda.variant_launches))


@pytest.mark.parametrize("H,dtype", [(256, torch.bfloat16),
                                     (64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (512, torch.bfloat16),
                                     (64, torch.float32)])
def test_scan_bwd_launch_reaches_its_variant(fake_lib, H, dtype):
    lib = fake_lib()
    a = _inputs(H, dtype)
    T, B = a[0].shape[:2]
    variant = ts.scan_bwd_variant(H, dtype)
    launches, by_variant = _counts()
    out = ts._scan_bwd_launch(*a)
    by_variant[variant] += 1
    assert _counts() == (launches + 1, by_variant)
    calls = [(n, args) for n, args in lib.log
             if n in ("dl4j_lstm_scan_bwd", "dl4j_lstm_scan_bwd_cluster",
                      "dl4j_lstm_drw_sm90")]
    names = [n for n, _ in calls]
    sweep = "dl4j_lstm_scan_bwd_cluster" if variant == "cluster" \
        else "dl4j_lstm_scan_bwd"
    assert names == [sweep] + (["dl4j_lstm_drw_sm90"]
                               if dtype == torch.bfloat16 else [])
    (_, sargs) = calls[0]
    fn = getattr(lib, sweep)
    assert len(sargs) == len(fn.argtypes)
    dxw, drw, dpi, dpf, dpo, dh0, dc0 = out
    if variant == "cluster":
        # xw .. dcs, dxw, dh0, dc0, dp_part, T, B, H, stream
        assert fn.argtypes == [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        assert sargs[0] == a[0].data_ptr() and sargs[1] == a[1].data_ptr()
        assert sargs[11:14] == (dxw.data_ptr(), dh0.data_ptr(),
                                dc0.data_ptr())
        assert sargs[15:] == (T, B, H, 61)
    else:
        # xw, rw, rwt, pi .. dcs, dxw, dh0, dc0, dp_part, drw, T, B, H,
        # dtype, stream
        assert fn.argtypes == [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        assert sargs[12:15] == (dxw.data_ptr(), dh0.data_ptr(),
                                dc0.data_ptr())
        assert sargs[17:] == (T, B, H, ts._DTYPE_CODE[dtype], 61)
        # rwt only for the fp32 sweep, dRW's buffer only for fp32's dRW
        assert (sargs[2] is None) == (dtype == torch.bfloat16)
        assert (sargs[16] is None) == (dtype == torch.bfloat16)
    if dtype == torch.bfloat16:
        (_, dargs) = calls[1]
        dfn = lib.dl4j_lstm_drw_sm90
        assert dfn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        assert dargs[2] == dxw.data_ptr()
        assert dargs[4:] == (T, B, H, _FakeLib.CHUNKS, 61)
    assert dxw.shape == (T, B, 4 * H) and dxw.dtype == dtype
    assert drw.shape == (H, 4 * H) and drw.dtype == dtype
    assert dpi.shape == dpf.shape == dpo.shape == (H,)
    assert dh0.shape == dc0.shape == (B, H)


@pytest.mark.parametrize("H", [256, 64, 32])
def test_scan_bwd_partial_buffers(fake_lib, monkeypatch, H):
    """The peephole partials are one (3, H) row per cluster of 128 batch
    rows (cluster sweep) or per tile of the tile sweep, and the dRW slab
    one (H, 4H) fp32 partial per chunk: both summed before they return."""
    fake_lib()
    seen = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            seen.setdefault("fp32", []).append(tuple(t.shape))
        return t
    monkeypatch.setattr(ts.torch, "empty", empty)
    a = _inputs(H, torch.bfloat16, T=2, B=300)
    ts._scan_bwd_launch(*a)
    rows = 128 if ts.scan_bwd_variant(H, torch.bfloat16) == "cluster" \
        else _tile_rows(H, 2, True)
    assert seen["fp32"] == [(-(-300 // rows), 3, H),
                            (_FakeLib.CHUNKS, H, 4 * H)]


@pytest.mark.parametrize("H,fail", [
    (256, "dl4j_lstm_scan_bwd_cluster"), (256, "dl4j_lstm_drw_sm90"),
    (32, "dl4j_lstm_scan_bwd"), (32, "dl4j_lstm_drw_sm90")])
def test_scan_bwd_failed_launch_raises_and_counts_nothing(fake_lib, H, fail):
    fake_lib(fail=fail, err=700)
    a = _inputs(H, torch.bfloat16)
    before = _counts()
    source = "dl4j_lstm_scan_error_string" if fail == "dl4j_lstm_scan_bwd" \
        else "dl4j_lstm_scan_bwd_error_string"
    with pytest.raises(RuntimeError, match=f"error 700 from {source}"):
        ts._scan_bwd_launch(*a)
    assert _counts() == before


@pytest.mark.parametrize("chunks", [1, 2, 3, 7, 8, 33, 66])
def test_drw_partials_sum_in_a_fixed_order(chunks):
    """The chunk sum equals a plain sum (float64), and in fp32 it is the
    same pairwise tree every time: chunk z takes chunk z + n - n // 2
    while n > 1 are left."""
    rng = np.random.RandomState(chunks)
    slab = torch.from_numpy(rng.randn(chunks, 4, 16))
    torch.testing.assert_close(ts.reduce_drw_partials(slab.clone()),
                               slab.sum(0), rtol=0, atol=1e-12)
    s32 = slab.float()
    tree = list(s32.clone())
    while len(tree) > 1:
        n, half = len(tree), len(tree) // 2
        tree = [tree[z] + tree[n - half + z] for z in range(half)] + \
            tree[half:n - half]
    got = ts.reduce_drw_partials(s32.clone())
    assert torch.equal(got, tree[0])
    assert torch.equal(got, ts.reduce_drw_partials(s32.clone()))


def _scan_args(T, B, H, seed):
    rng = np.random.RandomState(seed)
    a = [rng.randn(T, B, 4 * H) * 0.5, rng.randn(H, 4 * H) * H ** -0.5]
    a += [rng.randn(H) * 0.2 for _ in range(3)]
    a += [rng.randn(B, H) * 0.3 for _ in range(2)]
    return a, [rng.randn(T, B, H), rng.randn(T, B, H)]


def _pallas_vjp(args, cots):
    (ys, cs), vjp = jax.vjp(graves_lstm_scan_pallas, *args)
    return ys, cs, vjp(cots)


@pytest.fixture(scope="module")
def pallas_vjp():
    return jax.jit(_pallas_vjp)


@pytest.mark.parametrize("H,T,B", [(64, 3, 4), (128, 2, 3)])
def test_plain_backward_at_cluster_widths_matches_pallas(pallas_vjp, H, T, B):
    """The plain version the cluster sweep is held to on the card, at the
    widths that take it, against the JAX kernel's VJP."""
    assert ts.scan_bwd_variant(H, torch.bfloat16) == "cluster"
    args, cots = _scan_args(T, B, H, seed=H)
    rys, rcs, rgrads = pallas_vjp([jnp.asarray(x) for x in args],
                                  tuple(jnp.asarray(c) for c in cots))
    targs = [torch.from_numpy(x) for x in args]
    ys, cs = ts.graves_lstm_scan_plain(*targs)
    np.testing.assert_allclose(ys, rys, atol=TOL, rtol=0)
    np.testing.assert_allclose(cs, rcs, atol=TOL, rtol=0)
    grads = ts.graves_lstm_scan_bwd_plain(*targs, ys, cs,
                                          *map(torch.from_numpy, cots))
    for name, g, r in zip(NAMES, grads, rgrads):
        np.testing.assert_allclose(g, r, atol=TOL, rtol=0, err_msg=name)
