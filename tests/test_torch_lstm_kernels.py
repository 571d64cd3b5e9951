"""The port's LSTM kernels' plain versions against the JAX package's Pallas
kernels (in interpret mode, as tests/test_lstm_scan_fused.py runs them)
and their lax/jnp references, in float64 on the CPU.

- K7: `graves_lstm_scan_plain` / `graves_lstm_scan_bwd_plain` (and the
  autograd function that dispatches to them on the CPU) against
  `graves_lstm_scan_pallas` and `graves_lstm_scan_xla`: ys, cs and all
  seven gradients, with a non-zero cotangent on cs.
- K8 / K9: the gate cells' plain forward and backward against
  `graves_gates_pallas` / `lstm_gates_pallas` and their `_xla` versions.

Inputs are numpy draws handed to both packages. Tolerance 1e-10.

K7's forward has two kernels on the card, chosen by
`scan_fwd_variant(H, dtype)` before the launch: the cluster kernel (bf16
at a padded H of 64, 128 or 256) and the tile kernel (every other H, and
fp32). The rule, `scan_fits` beside it, and each variant's launch run
here against recording stand-in libraries (argtypes, arguments, launch
counters, failed launches); the kernels themselves are held against the
plain version on the card by chip_smoke.py.
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.lstm_scan_fused import (graves_lstm_scan_pallas,
                                                    graves_lstm_scan_xla)
from deeplearning4j_tpu.ops.pallas_kernels import (graves_gates_pallas,
                                                   graves_gates_xla,
                                                   lstm_gates_pallas,
                                                   lstm_gates_xla)
from deeplearning4j_tpu_torch.ops import lstm_gates as tg
from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

TOL = 1e-10
H = 8


def _scan_args(T, B, seed, zero_state=False):
    rng = np.random.RandomState(seed)
    a = [rng.randn(T, B, 4 * H) * 0.5, rng.randn(H, 4 * H) * 0.3]
    a += [rng.randn(H) * 0.2 for _ in range(3)]
    a += [np.zeros((B, H)) if zero_state else rng.randn(B, H) * 0.3
          for _ in range(2)]
    cot = [rng.randn(T, B, H), rng.randn(T, B, H)]
    return a, cot


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=TOL,
                               rtol=0, err_msg=what)


NAMES = ("dxw", "drw", "dpi", "dpf", "dpo", "dh0", "dc0")


@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("B", [9, 12, 20])
def test_scan_plain_matches_pallas_and_xla(B, T):
    args, (dys, dcs) = _scan_args(T, B, seed=B + T)
    ja = [jnp.asarray(a) for a in args]
    ys, cs = ts.graves_lstm_scan_plain(*map(_t, args))
    for ref_fn in (graves_lstm_scan_pallas, graves_lstm_scan_xla):
        (rys, rcs), vjp = jax.vjp(ref_fn, *ja)
        _close(ys, rys, f"ys vs {ref_fn.__name__}")
        _close(cs, rcs, f"cs vs {ref_fn.__name__}")
        ref_grads = vjp((jnp.asarray(dys), jnp.asarray(dcs)))
        grads = ts.graves_lstm_scan_bwd_plain(*map(_t, args), ys, cs,
                                              _t(dys), _t(dcs))
        for name, g, r in zip(NAMES, grads, ref_grads):
            _close(g, r, f"{name} vs {ref_fn.__name__}")


@pytest.mark.parametrize("zero_state", [False, True])
def test_scan_autograd_matches_pallas(zero_state):
    """The differentiable entry point on CPU tensors: values and the seven
    gradients through torch.autograd, a cotangent on both outputs."""
    args, (dys, dcs) = _scan_args(5, 9, seed=3, zero_state=zero_state)
    ts_in = [_t(a).requires_grad_(True) for a in args]
    ys, cs = ts.graves_lstm_scan(*ts_in)
    grads = torch.autograd.grad((ys * _t(dys)).sum() + (cs * _t(dcs)).sum(),
                                ts_in)
    (rys, rcs), vjp = jax.vjp(graves_lstm_scan_pallas,
                              *[jnp.asarray(a) for a in args])
    _close(ys.detach(), rys, "ys")
    _close(cs.detach(), rcs, "cs")
    for name, g, r in zip(NAMES, grads,
                          vjp((jnp.asarray(dys), jnp.asarray(dcs)))):
        _close(g, r, name)
    assert ts.graves_lstm_scan_fwd_cuda.launches == 0
    assert ts.graves_lstm_scan_bwd_cuda.launches == 0


def test_scan_plain_keeps_the_storage_rounding():
    """In float32 storage the plain forward rounds h and c every step:
    it equals a float64 loop that rounds h and c to float32 after each
    step, and so stays apart from the unrounded float64 recurrence."""
    args, _ = _scan_args(6, 4, seed=11)
    a32 = [_t(a).float() for a in args]
    ys, cs = ts.graves_lstm_scan_plain(*a32)
    xw, rw, pi, pf, po, h, c = [a.double() for a in a32]
    for t in range(xw.shape[0]):
        g = xw[t] + h @ rw
        i = torch.sigmoid(g[:, :H] + c * pi)
        f = torch.sigmoid(g[:, H:2 * H] + c * pf)
        c_new = f * c + i * torch.tanh(g[:, 3 * H:])
        o = torch.sigmoid(g[:, 2 * H:3 * H] + c_new * po)
        h = (o * torch.tanh(c_new)).float().double()
        c = c_new.float().double()
        np.testing.assert_allclose(ys[t].double(), h, atol=2e-6, rtol=0)
        np.testing.assert_allclose(cs[t].double(), c, atol=2e-6, rtol=0)
    assert ys.dtype == cs.dtype == torch.float32


def _gate_args(B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 4 * H), rng.randn(B, H) * 0.5,
            *(rng.randn(H) * 0.3 for _ in range(3)),
            rng.randn(B, H), rng.randn(B, H))


@pytest.mark.parametrize("B", [1, 9, 20])
def test_graves_gates_plain_matches_pallas(B):
    gates, c, pi, pf, po, dc, dh = _gate_args(B, seed=B)
    fwd = tg.graves_gates_plain(*map(_t, (gates, c, pi, pf, po)))
    bwd = tg.graves_gates_bwd_plain(*map(_t, (gates, c, pi, pf, po, dc,
                                              dh)))
    for ref_fn in (graves_gates_pallas, graves_gates_xla):
        out, vjp = jax.vjp(ref_fn, *map(jnp.asarray, (gates, c, pi, pf,
                                                      po)))
        for p, r in zip(fwd, out):
            _close(p, r, f"forward vs {ref_fn.__name__}")
        for p, r in zip(bwd, vjp((jnp.asarray(dc), jnp.asarray(dh)))):
            _close(p, r, f"backward vs {ref_fn.__name__}")


@pytest.mark.parametrize("B", [1, 9, 20])
def test_lstm_gates_plain_matches_pallas(B):
    gates, c, _, _, _, dc, dh = _gate_args(B, seed=40 + B)
    fwd = tg.lstm_gates_plain(_t(gates), _t(c))
    bwd = tg.lstm_gates_bwd_plain(*map(_t, (gates, c, dc, dh)))
    for ref_fn in (lstm_gates_pallas, lstm_gates_xla):
        out, vjp = jax.vjp(ref_fn, jnp.asarray(gates), jnp.asarray(c))
        for p, r in zip(fwd, out):
            _close(p, r, f"forward vs {ref_fn.__name__}")
        for p, r in zip(bwd, vjp((jnp.asarray(dc), jnp.asarray(dh)))):
            _close(p, r, f"backward vs {ref_fn.__name__}")


@pytest.mark.parametrize("peep", [False, True])
def test_gate_cells_autograd_on_cpu(peep):
    """The differentiable cells take the plain versions on CPU tensors (no
    launch counted) and give the JAX Pallas cell's gradients."""
    gates, c, pi, pf, po, dc, dh = _gate_args(6, seed=77)
    ins = [_t(a).requires_grad_(True)
           for a in ((gates, c, pi, pf, po) if peep else (gates, c))]
    out = (tg.graves_gates if peep else tg.lstm_gates)(*ins)
    grads = torch.autograd.grad(
        (out[0] * _t(dc)).sum() + (out[1] * _t(dh)).sum(), ins)
    ref_fn = graves_gates_pallas if peep else lstm_gates_pallas
    _, vjp = jax.vjp(ref_fn, *[jnp.asarray(a.detach().numpy())
                               for a in ins])
    for g, r in zip(grads, vjp((jnp.asarray(dc), jnp.asarray(dh)))):
        _close(g, r, "gradient")
    for fn in (tg.lstm_gates_cuda, tg.lstm_gates_bwd_cuda,
               tg.graves_gates_cuda, tg.graves_gates_bwd_cuda):
        assert fn.launches == 0


@pytest.mark.parametrize("kw,match", [
    (dict(gate_math="native"), "ROADMAP"),
    (dict(grid="tm"), "no counterpart"),
    (dict(k_steps=2), "no counterpart")])
def test_scan_configure_raises_for_tpu_knobs(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        ts.configure(**kw)
    assert ts.configure(gate_math="fp32") == {"gate_math": "fp32"}


def _cpu_calls():
    z = torch.zeros
    s = (z(3, 2, 64), z(16, 64), z(16), z(16), z(16), z(2, 16), z(2, 16))
    ys = z(3, 2, 16)
    g = (z(2, 64), z(2, 16))
    p = (z(16), z(16), z(16))
    return {
        "graves_lstm_scan_fwd": lambda: ts.graves_lstm_scan_fwd_cuda(*s),
        "graves_lstm_scan_bwd": lambda: ts.graves_lstm_scan_bwd_cuda(
            *s, ys, ys, ys, ys),
        "lstm_gates": lambda: tg.lstm_gates_cuda(*g),
        "lstm_gates_bwd": lambda: tg.lstm_gates_bwd_cuda(*g, g[1], g[1]),
        "graves_gates": lambda: tg.graves_gates_cuda(*g, *p),
        "graves_gates_bwd": lambda: tg.graves_gates_bwd_cuda(*g, *p, g[1],
                                                             g[1]),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    the plain version itself."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _cpu_calls()[name]()


@pytest.mark.parametrize("H_true", [8, 13])
def test_scan_padding_is_exact(H_true):
    """The CUDA wrappers' H padding (to a multiple of 16) around the plain
    versions equals the plain versions at the true H, forward and
    backward."""
    rng = np.random.RandomState(11)
    T, B = 5, 3
    args = [_t(rng.randn(T, B, 4 * H_true) * 0.5),
            _t(rng.randn(H_true, 4 * H_true) * 0.3)]
    args += [_t(rng.randn(H_true) * 0.2) for _ in range(3)]
    args += [_t(rng.randn(B, H_true) * 0.3) for _ in range(2)]
    ys, cs = ts.graves_lstm_scan_plain(*args)
    pys, pcs = ts.padded_scan_fwd(ts.graves_lstm_scan_plain, *args)
    assert pys.shape == ys.shape
    torch.testing.assert_close(pys, ys, rtol=0, atol=TOL)
    torch.testing.assert_close(pcs, cs, rtol=0, atol=TOL)
    dys, dcs = _t(rng.randn(T, B, H_true)), _t(rng.randn(T, B, H_true))
    ref = ts.graves_lstm_scan_bwd_plain(*args, ys, cs, dys, dcs)
    got = ts.padded_scan_bwd(ts.graves_lstm_scan_bwd_plain, *args, ys, cs,
                             dys, dcs)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0, atol=TOL)


def test_scan_fits_on_the_cpu_for_any_h():
    assert ts.scan_fits(1536, torch.bfloat16, "cpu")
    assert ts.scan_fits(200, torch.float64, "cpu")


@pytest.mark.parametrize("H,dtype,variant", [
    (256, torch.bfloat16, "cluster"), (250, torch.bfloat16, "cluster"),
    (64, torch.bfloat16, "cluster"), (128, torch.bfloat16, "cluster"),
    (32, torch.bfloat16, "tile"), (200, torch.bfloat16, "tile"),
    (512, torch.bfloat16, "tile"), (1536, torch.bfloat16, "tile"),
    (256, torch.float32, "tile"), (64, torch.float32, "tile")])
def test_scan_fwd_variant_rule(H, dtype, variant):
    """The cluster kernel keeps H / 8 units' RW columns of all four gates
    in each of 8 CTAs (8 H^2 / 8 bytes, 64 KB at H 256) beside its h
    buffers; at H 512 that slice alone is 256 KB, past a CTA's 227 KB,
    and units per CTA must be a multiple of 8: the other H take the tile
    kernel, and so does fp32."""
    assert ts.scan_fwd_variant(H, dtype) == variant
    if variant == "cluster":
        Hp = -(-H // 16) * 16
        assert Hp in ts.CLUSTER_FWD_H and (Hp // 8) % 8 == 0
        assert Hp * (Hp // 2) * 2 + 4 * 64 * Hp * 2 <= 232448


class _FakeFn:
    def __init__(self, name, log, ret):
        self.name, self.log, self.ret = name, log, ret
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        self.log.append((self.name, args))
        return self.ret(*args) if callable(self.ret) else self.ret


def _tile_rows(H, dtype, bwd):
    """The tile kernel's batch rows per CTA (lstm_scan.cu `pick_bt`,
    transcribed): the largest of 64/32/16 (down to 8 in fp32) whose
    shared memory fits in 232,448 bytes, 0 when none does."""
    if H <= 0 or H % 16 or dtype not in (0, 2):
        return 0
    tc = dtype == 2
    elt, stage = (2, 4 * 8 * 4 * 256) if tc else (4, 0)
    ldh, ldg = (H + 8, 4 * H + 8) if tc else (H, 4 * H)
    bt = 64
    while bt >= (16 if tc else 8):
        if bwd:
            owners = 2 if tc else bt // 8
            need = stage + 12 * owners * H + elt * (bt * ldh + bt * ldg)
        else:
            need = elt * (2 * bt * ldh + bt * H) + stage
        if need <= 232448:
            return bt
        bt //= 2
    return 0


class _FakeScanLib:
    NAMES = {"dl4j_lstm_scan_fwd": None, "dl4j_lstm_scan_bwd": None,
             "dl4j_lstm_scan_tile": _tile_rows,
             "dl4j_lstm_scan_error_string": None,
             "dl4j_lstm_scan_fwd_cluster": None,
             "dl4j_lstm_scan_fwd_clusters": 16,
             "dl4j_lstm_scan_fwd_cluster_smem": 0,
             "dl4j_lstm_scan_fwd_cluster_error_string": None}

    def __init__(self, err=0):
        self.log = []
        for n, ret in self.NAMES.items():
            setattr(self, n, _FakeFn(n, self.log, err if ret is None
                                     else ret))


@pytest.fixture
def fake_scan(monkeypatch):
    """The real `_library` / `_cluster_library` set-up on one stand-in
    library and a stand-in stream, so that the launch code runs on CPU
    tensors."""
    libs = {}

    def install(err=0):
        libs["lib"] = _FakeScanLib(err)
        monkeypatch.setattr(ts.build, "load", lambda source: libs["lib"])
        monkeypatch.setattr(
            torch.cuda, "current_stream",
            lambda device=None: SimpleNamespace(cuda_stream=53))
        return libs["lib"]
    return install


def test_scan_fits_is_unchanged_by_the_cluster_variant(fake_scan):
    """scan_fits still asks the tile kernel's forward and backward tiles
    (the layers fall back to K8/K9 only where those do not fit): on the
    card every H from 16 to 1536 fits exactly where both tiles do, in
    bf16 up to H 1072 and in fp32 up to 1344, every cluster H fits, and
    H 1536 fits in neither."""
    fake_scan()
    for dt, code, top in ((torch.bfloat16, 2, 1072),
                          (torch.float32, 0, 1344)):
        for H in range(16, 1537, 16):
            fits = ts.scan_fits(H, dt, "cuda")
            assert fits == bool(_tile_rows(H, code, False)
                                and _tile_rows(H, code, True))
            assert fits == (H <= top)
    for H in ts.CLUSTER_FWD_H:
        assert ts.scan_fits(H, torch.bfloat16, "cuda")


def _scan_inputs(H, dtype, T=3, B=5):
    rng = np.random.RandomState(H)
    a = [rng.randn(T, B, 4 * H), rng.randn(H, 4 * H)]
    a += [rng.randn(H) for _ in range(3)] + [rng.randn(B, H)
                                             for _ in range(2)]
    return [_t(x).to(dtype) for x in a]


@pytest.mark.parametrize("H,dtype", [(256, torch.bfloat16),
                                     (64, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (512, torch.bfloat16),
                                     (256, torch.float32)])
def test_scan_fwd_launch_reaches_its_variant(fake_scan, H, dtype):
    lib = fake_scan()
    a = _scan_inputs(H, dtype)
    variant = ts.scan_fwd_variant(H, dtype)
    before = ts.graves_lstm_scan_fwd_cuda.launches
    by_variant = dict(ts.graves_lstm_scan_fwd_cuda.variant_launches)
    ys, cs = ts._scan_fwd_launch(*a)
    assert ts.graves_lstm_scan_fwd_cuda.launches == before + 1
    by_variant[variant] += 1
    assert ts.graves_lstm_scan_fwd_cuda.variant_launches == by_variant
    launches = [(n, args) for n, args in lib.log
                if n in ("dl4j_lstm_scan_fwd", "dl4j_lstm_scan_fwd_cluster")]
    ((name, args),) = launches
    fn = getattr(lib, name)
    if variant == "cluster":
        assert name == "dl4j_lstm_scan_fwd_cluster"
        assert fn.argtypes == [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        assert args[9:] == (3, 5, H, 53)
    else:
        assert name == "dl4j_lstm_scan_fwd"
        assert fn.argtypes == [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        assert args[9:] == (3, 5, H, 2 if dtype == torch.bfloat16 else 0,
                            53)
    assert len(args) == len(fn.argtypes)
    assert args[0] == a[0].data_ptr() and args[1] == a[1].data_ptr()
    assert (args[7], args[8]) == (ys.data_ptr(), cs.data_ptr())
    assert ys.shape == cs.shape == (3, 5, H) and ys.dtype == dtype


@pytest.mark.parametrize("H", [256, 32])
def test_scan_fwd_failed_launch_raises(fake_scan, H):
    fake_scan(err=700)
    a = _scan_inputs(H, torch.bfloat16)
    variant = ts.scan_fwd_variant(H, torch.bfloat16)
    before = ts.graves_lstm_scan_fwd_cuda.launches
    by_variant = dict(ts.graves_lstm_scan_fwd_cuda.variant_launches)
    source = ("dl4j_lstm_scan_fwd_cluster_error_string"
              if variant == "cluster" else "dl4j_lstm_scan_error_string")
    with pytest.raises(RuntimeError, match=f"error 700 from {source}"):
        ts._scan_fwd_launch(*a)
    assert ts.graves_lstm_scan_fwd_cuda.launches == before
    assert ts.graves_lstm_scan_fwd_cuda.variant_launches == by_variant
