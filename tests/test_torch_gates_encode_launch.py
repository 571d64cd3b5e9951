"""The launches of K8/K9 (the LSTM cells, `ops/lstm_gates.py`) and K11
(threshold encoding, `ops/threshold_encode.py`) on recording stand-in
libraries, on the CPU.

- K8's backward is one library launch a call, given its partials, a
  ticket buffer kept per stream and capture and its dpi/dpf/dpo output,
  which come back in the peepholes' dtype; K9's backward is one launch
  with none of them; each call takes the 16-byte path exactly where
  `vector_path` allows it; a failed launch raises and counts nothing.
- K11 encodes a list of tensors in one library call whose table holds each
  tensor's pointers and n in order, empty tensors skipped; the one-tensor
  call passes what a single call passes; the stand-in computes the plain
  version through the table's pointers, so the list form is held bit for
  bit against `threshold_encode_plain`, and `ParallelWrapper` in
  SHARED_GRADIENTS makes one call a replica a step.
The kernels themselves are held against their plain versions on the card
by chip_smoke.py.
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

import torch

from deeplearning4j_tpu_torch import (Activation, DenseLayer, InputType,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      WeightInit)
from deeplearning4j_tpu_torch.nn.updater.updaters import Adam
from deeplearning4j_tpu_torch.ops import lstm_gates as tg
from deeplearning4j_tpu_torch.ops import threshold_encode as te
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, TrainingMode,
                                               make_mesh)
from deeplearning4j_tpu_torch.parallel import accumulation as acc
from deeplearning4j_tpu_torch.util.flat_params import flatten_params

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

STREAM = 53
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


class _FakeFn:
    def __init__(self, name, lib, ret):
        self.name, self.lib, self.ret = name, lib, ret
        self.argtypes = self.restype = None

    def __call__(self, *args):
        if self.name.endswith("error_string"):
            return f"error {args[0]} from {self.name}".encode()
        if self.name in self.lib.LAUNCHES:
            self.lib.log.append((self.name, args))
            if self.lib.err:
                return self.lib.err
        return self.ret(*args) if callable(self.ret) else self.ret


class _FakeGatesLib:
    LAUNCHES = ("dl4j_lstm_gates_fwd", "dl4j_lstm_gates_bwd")

    def __init__(self, err=0):
        self.log, self.err, self.capture = [], err, 0
        rets = {"dl4j_lstm_gates_fwd": 0, "dl4j_lstm_gates_bwd": 0,
                "dl4j_lstm_gates_blocks": lambda B: -(-B // 128),
                "dl4j_lstm_gates_tickets": lambda H: -(-H // 32),
                "dl4j_capture_id": lambda stream: self.capture,
                "dl4j_lstm_gates_error_string": None}
        for n, ret in rets.items():
            setattr(self, n, _FakeFn(n, self, ret))


@pytest.fixture
def fake_gates(monkeypatch):
    """The real `_library` set-up on a stand-in library and stream, so that
    the launch code runs on CPU tensors; counters and tickets restored."""
    def install(err=0):
        lib = _FakeGatesLib(err)
        monkeypatch.setattr(tg.build, "load", lambda source: lib)
        monkeypatch.setattr(
            torch.cuda, "current_stream",
            lambda device=None: SimpleNamespace(cuda_stream=STREAM))
        monkeypatch.setattr(tg, "_TICKETS", {})
        for fn in (tg.graves_gates_cuda, tg.graves_gates_bwd_cuda,
                   tg.lstm_gates_cuda, tg.lstm_gates_bwd_cuda):
            monkeypatch.setattr(fn, "launches", fn.launches)
            monkeypatch.setattr(fn, "path_launches", dict(fn.path_launches))
        return lib
    return install


def _odd_view(t):
    """t's values in a view one element past an aligned allocation."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def _cell(B, H, dtype, odd=False, seed=0):
    rng = np.random.RandomState(seed)
    t = [torch.from_numpy(rng.randn(*s)).to(dtype)
         for s in ((B, 4 * H), (B, H), (H,), (H,), (H,), (B, H), (B, H))]
    if odd:
        t[0] = _odd_view(t[0])
    return t


@pytest.mark.parametrize("H,dtype,odd,vec", [
    (256, torch.bfloat16, False, True), (100, torch.bfloat16, False, False),
    (100, torch.float32, False, True), (98, torch.float32, False, False),
    (256, torch.bfloat16, True, False), (256, torch.float32, True, False)])
def test_k8_backward_is_one_launch_with_tickets(fake_gates, H, dtype, odd,
                                                vec):
    lib = fake_gates()
    gates, c, pi, pf, po, dc, dh = _cell(5, H, dtype, odd)
    assert tg.vector_path(H, [gates, c, pi, pf, po, dc, dh]) == vec
    fn = tg.graves_gates_bwd_cuda
    before, paths = fn.launches, dict(fn.path_launches)
    out = tg._gates_bwd_launch(fn, "graves_gates_bwd", gates, c,
                               [pi, pf, po], dc, dh)
    ((name, args),) = lib.log
    assert name == "dl4j_lstm_gates_bwd"
    assert len(args) == len(lib.dl4j_lstm_gates_bwd.argtypes) == 17
    assert lib.dl4j_lstm_gates_bwd.argtypes == [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    tickets = tg._TICKETS[(gates.device, STREAM, 0)][-1]
    assert args[10] == tickets.data_ptr() and torch.all(tickets == 0)
    assert tickets.numel() >= -(-H // 32) and args[9] is not None
    assert args[12:] == (5, H, 2 if dtype == torch.bfloat16 else 0,
                         int(vec), STREAM)
    dgates, dc_prev, dpi, dpf, dpo = out
    assert (args[7], args[8]) == (dgates.data_ptr(), dc_prev.data_ptr())
    assert args[11] == dpi.data_ptr()
    assert dgates.shape == (5, 4 * H) and dc_prev.shape == (5, H)
    for d in (dpi, dpf, dpo):
        assert d.shape == (H,) and d.dtype == pi.dtype
    assert fn.launches == before + 1
    paths["vector" if vec else "scalar"] += 1
    assert fn.path_launches == paths
    # a second call reuses the stream's tickets; a graph capture has its own
    tg._gates_bwd_launch(fn, "graves_gates_bwd", gates, c, [pi, pf, po],
                         dc, dh)
    lib.capture = 9
    tg._gates_bwd_launch(fn, "graves_gates_bwd", gates, c, [pi, pf, po],
                         dc, dh)
    firsts = [a[10] for _, a in lib.log]
    assert firsts[0] == firsts[1] != firsts[2]
    assert set(tg._TICKETS) == {(gates.device, STREAM, 0),
                                (gates.device, STREAM, 9)}


@pytest.mark.parametrize("H,dtype,vec", [(256, torch.bfloat16, True),
                                         (100, torch.bfloat16, False),
                                         (64, torch.float32, True)])
def test_k9_and_forward_launches(fake_gates, H, dtype, vec):
    """K9's backward: one launch, no partials, tickets or dp; K8's and
    K9's forwards: one launch each, the same path rule."""
    lib = fake_gates()
    gates, c, pi, pf, po, dc, dh = _cell(3, H, dtype, seed=1)
    dgates, dc_prev = tg._gates_bwd_launch(
        tg.lstm_gates_bwd_cuda, "lstm_gates_bwd", gates, c, [], dc, dh)
    tg._gates_fwd_launch(tg.lstm_gates_cuda, "lstm_gates", gates, c, [])
    c_new, h_new = tg._gates_fwd_launch(tg.graves_gates_cuda, "graves_gates",
                                        gates, c, [pi, pf, po])
    (n1, bwd), (n2, fwd9), (n3, fwd8) = lib.log
    assert (n1, n2, n3) == ("dl4j_lstm_gates_bwd", "dl4j_lstm_gates_fwd",
                            "dl4j_lstm_gates_fwd")
    assert bwd[2:5] == (None,) * 3 and bwd[9:12] == (None,) * 3
    assert len(fwd8) == len(lib.dl4j_lstm_gates_fwd.argtypes) == 12
    assert fwd9[2:5] == (None,) * 3 and None not in fwd8[:7]
    assert (fwd8[5], fwd8[6]) == (c_new.data_ptr(), h_new.data_ptr())
    code = 2 if dtype == torch.bfloat16 else 0
    assert fwd8[7:] == (3, H, code, int(vec), STREAM)
    assert bwd[12:] == (3, H, code, int(vec), STREAM)
    assert dgates.shape == gates.shape and dc_prev.dtype == dtype
    assert tg._TICKETS == {}
    for fn in (tg.lstm_gates_bwd_cuda, tg.lstm_gates_cuda,
               tg.graves_gates_cuda):
        assert fn.path_launches["vector" if vec else "scalar"] >= 1


@pytest.mark.parametrize("peep", [True, False])
def test_gates_failed_launch_raises_and_counts_nothing(fake_gates, peep):
    fake_gates(err=700)
    gates, c, pi, pf, po, dc, dh = _cell(4, 64, torch.bfloat16)
    peeps = [pi, pf, po] if peep else []
    for fn, call in (
            (tg.graves_gates_bwd_cuda if peep else tg.lstm_gates_bwd_cuda,
             lambda w: tg._gates_bwd_launch(w, "cell_bwd", gates, c, peeps,
                                            dc, dh)),
            (tg.graves_gates_cuda if peep else tg.lstm_gates_cuda,
             lambda w: tg._gates_fwd_launch(w, "cell", gates, c, peeps))):
        before, paths = fn.launches, dict(fn.path_launches)
        with pytest.raises(RuntimeError, match="launch failed: error 700"):
            call(fn)
        assert fn.launches == before and fn.path_launches == paths


# ---------------------------------------------------------------- K11
def _as_tensor(ptr, n, dtype):
    """A copy of n elements of dtype at address ptr."""
    out = torch.empty(n, dtype=dtype)
    ctypes.memmove(out.data_ptr(), ptr, n * out.element_size())
    return out


class _FakeEncodeLib:
    LAUNCHES = ("dl4j_threshold_encode",)
    DTYPES = {0: torch.float32, 2: torch.bfloat16, 3: torch.float64}

    def __init__(self, err=0, max_entries=256):
        self.log, self.err = [], err
        self.dl4j_threshold_encode = _FakeFn("dl4j_threshold_encode", self,
                                             self._encode)
        self.dl4j_threshold_encode_max_entries = _FakeFn(
            "dl4j_threshold_encode_max_entries", self, max_entries)
        self.dl4j_threshold_encode_error_string = _FakeFn(
            "dl4j_threshold_encode_error_string", self, None)

    def _encode(self, table, count, t, dtype, stream):
        """The plain version through the table's pointers."""
        dt = self.DTYPES[dtype]
        for e in table[:count]:
            u, r = (_as_tensor(p, e.n, dt) for p in (e.update, e.residual))
            m, nr = te.threshold_encode_plain(u, r, t)
            for dst, src in ((e.msg, m), (e.new_residual, nr)):
                ctypes.memmove(dst, src.data_ptr(), e.n * src.element_size())
        return 0


@pytest.fixture
def fake_encode(monkeypatch):
    def install(**kw):
        lib = _FakeEncodeLib(**kw)
        monkeypatch.setattr(te.build, "load", lambda source: lib)
        monkeypatch.setattr(
            torch.cuda, "current_stream",
            lambda device=None: SimpleNamespace(cuda_stream=STREAM))
        monkeypatch.setattr(te.threshold_encode_list_cuda, "launches",
                            te.threshold_encode_list_cuda.launches)
        return lib
    return install


def _bits(a):
    return a.contiguous().view(_BITS[a.element_size()])


def _pairs(shapes, dtype, seed=0, offsets=None):
    """(updates, residuals): N(0, 1.5e-3) updates, N(0, 5e-4) residuals,
    as views at `offsets` elements into two flat buffers (packed when
    None)."""
    rng = np.random.RandomState(seed)
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = offsets or list(np.cumsum([0] + sizes[:-1]))
    flat = [torch.from_numpy(rng.randn(max(o + n for o, n in
                                           zip(offsets, sizes)) + 1)
                             * scale).to(dtype) for scale in (1.5e-3, 5e-4)]
    return [[f[o:o + n].view(s) for o, n, s in zip(offsets, sizes, shapes)]
            for f in flat]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_k11_list_is_one_call_over_a_table(fake_encode, dtype):
    lib = fake_encode()
    shapes = [(3, 5), (0,), (64,), (7, 1, 3), (1,), (0, 4), (130,)]
    ups, res = _pairs(shapes, dtype, seed=2,
                      offsets=[1, 40, 41, 110, 200, 210, 213])
    before = te.threshold_encode_list_cuda.launches
    msgs, new_res = te._list_launch(ups, res, 1e-3)
    ((name, (table, count, t, code, stream)),) = lib.log
    assert name == "dl4j_threshold_encode" and count == 5
    assert lib.dl4j_threshold_encode.argtypes == [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p]
    assert t == te.threshold_in(1e-3, dtype) and stream == STREAM
    assert code == {torch.float32: 0, torch.bfloat16: 2,
                    torch.float64: 3}[dtype]
    kept = [i for i, s in enumerate(shapes) if int(np.prod(s))]
    assert [(e.update, e.residual, e.msg, e.new_residual, e.n)
            for e in table[:count]] == [
        (ups[i].data_ptr(), res[i].data_ptr(), msgs[i].data_ptr(),
         new_res[i].data_ptr(), ups[i].numel()) for i in kept]
    assert te.threshold_encode_list_cuda.launches == before + 1
    elt = ups[0].element_size()
    # one allocation each for the messages and the residuals, each view at
    # its update's offset from 16 bytes
    for outs in (msgs, new_res):
        base = {o.untyped_storage().data_ptr() for o in outs}
        assert len(base) == 1
    for u, m, e in zip(ups, msgs, new_res):
        assert m.shape == e.shape == u.shape and m.dtype == dtype
        if u.numel():
            assert m.data_ptr() % 16 == e.data_ptr() % 16 == \
                u.data_ptr() % 16 and u.data_ptr() % elt == 0
    pm, pr = te.threshold_encode_list_plain(ups, res, 1e-3)
    for a, b in zip(msgs + new_res, pm + pr):
        assert torch.equal(_bits(a), _bits(b))


def test_k11_one_entry_and_long_lists(fake_encode):
    """The one-tensor call: a table of one entry with what a single call
    passes; a list longer than the kernel's table counts its launches."""
    lib = fake_encode(max_entries=4)
    u, r = _pairs([(3, 7)], torch.float32, seed=5)
    m, e = te._list_launch([u[0]], [r[0]], 0.37)
    ((_, (table, count, t, code, stream)),) = lib.log
    assert count == 1 and (code, stream) == (0, STREAM)
    assert (table[0].update, table[0].residual, table[0].msg,
            table[0].new_residual, table[0].n) == (
        u[0].data_ptr(), r[0].data_ptr(), m[0].data_ptr(), e[0].data_ptr(),
        21)
    assert t == te.threshold_in(0.37, torch.float32)
    before = te.threshold_encode_list_cuda.launches
    ups, res = _pairs([(2,)] * 9, torch.float32)
    te._list_launch(ups, res, 1e-3)
    assert len(lib.log) == 2 and lib.log[-1][1][1] == 9
    assert te.threshold_encode_list_cuda.launches == before + 3


def test_k11_failed_launch_raises_and_refusals(fake_encode):
    fake_encode(err=700)
    ups, res = _pairs([(4,), (5,)], torch.float32)
    before = te.threshold_encode_list_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed: error 700"):
        te._list_launch(ups, res, 1e-3)
    assert te.threshold_encode_list_cuda.launches == before
    with pytest.raises(TypeError, match="one dtype for all"):
        te._list_launch([ups[0], ups[1].double()], [res[0], res[1].double()],
                        1e-3)
    with pytest.raises(ValueError, match="does not match"):
        te._list_launch(ups, [res[0], res[0]], 1e-3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        te.threshold_encode_list_cuda(ups, res, 1e-3)
    assert te._list_launch([], [], 1e-3) == ([], [])
    assert te.threshold_encode_list_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_k11_list_on_the_cpu_is_plain_bit_for_bit(dtype):
    """On the CPU `threshold_encode_list` is `threshold_encode_plain` on
    each tensor, edges included (+-t, NaN, +-inf, -0.0)."""
    ups, res = _pairs([(6, 3), (0,), (40,)], dtype, seed=7)
    tv = te.threshold_in(1e-3, dtype)
    ups[2][:6] = torch.tensor([tv, -tv, float("nan"), float("inf"),
                               -float("inf"), -0.0], dtype=torch.float64)
    res[2][:6] = -0.0
    msgs, new_res = acc.threshold_encode_list(ups, res, 1e-3)
    for u, r, m, e in zip(ups, res, msgs, new_res):
        pm, pr = te.threshold_encode_plain(u, r, 1e-3)
        assert torch.equal(_bits(m), _bits(pm))
        assert torch.equal(_bits(e), _bits(pr))
    m1, e1 = acc.threshold_encode(ups[0], res[0], 1e-3)
    assert torch.equal(_bits(m1), _bits(msgs[0]))
    assert torch.equal(_bits(e1), _bits(new_res[0]))


def _mlp():
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .weight_init(WeightInit.XAVIER).activation(Activation.TANH)
            .updater(Adam(learning_rate=0.05)).dtype("float64").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("workers", [1, 2])
def test_shared_gradients_step_is_one_k11_call_a_replica(fake_encode,
                                                         monkeypatch,
                                                         workers):
    """SHARED_GRADIENTS through K11's launch (the stand-in computes the
    plain version): one library call a replica a step over the replica's
    leaves in tree order, and the same params, bit for bit, as the plain
    route."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 5))
    y = torch.from_numpy(np.eye(3)[rng.randint(0, 3, 8)])
    plain = ParallelWrapper(_mlp(), mesh=make_mesh(workers, device="cpu"),
                            training_mode=TrainingMode.SHARED_GRADIENTS)
    for _ in range(2):
        plain.fit(x, y)
    lib = fake_encode()
    monkeypatch.setattr(acc, "helper_for",
                        lambda name, plain_fn, like: te._list_launch)
    pw = ParallelWrapper(_mlp(), mesh=make_mesh(workers, device="cpu"),
                         training_mode=TrainingMode.SHARED_GRADIENTS)
    leaves = 4                      # two dense layers: W and b each
    for _ in range(2):
        before = len(lib.log)
        pw.fit(x, y)
        calls = lib.log[before:]
        assert len(calls) == workers
        assert all(args[1] == leaves for _, args in calls)
    assert torch.equal(_bits(pw.model.params()), _bits(plain.model.params()))
    for r in range(workers):
        assert torch.equal(_bits(flatten_params(pw._params[r])),
                           _bits(flatten_params(plain._params[r])))
