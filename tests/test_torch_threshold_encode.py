"""Threshold encoding (K11's plain version), the gradient-sharing
accumulators and `set_gradients_accumulator` in the port, against the JAX
package on the CPU.

- `threshold_encode` against the JAX package's `threshold_encode_pallas`
  (interpret mode, as tests/test_ops_helpers.py runs it) and its inline
  jnp form, bitwise, in fp32 and fp64, and in bf16 against the inline form;
  n 1, 1000 and 4097, with entries at exactly +-t (t the threshold in the
  dtype), one ulp either side, NaN, +-inf and -0.0.
- Both accumulators against the JAX package's on one sequence of stores:
  parties, decay, the floor and reset; messages and residuals bitwise.
- MultiLayerNetwork and ComputationGraph `fit` for 3 steps with an
  accumulator set (Encoded and Basic), float64, Adam: params, updater
  state and the residual within 1e-10 of the JAX package.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu import (Activation, Adam, DenseLayer, InputType,
                                MultiLayerNetwork, NeuralNetConfiguration,
                                OutputLayer, WeightInit)
from deeplearning4j_tpu.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu.nn.graph.computation_graph import ComputationGraph
from deeplearning4j_tpu.ops.helpers import helpers_enabled_ctx
from deeplearning4j_tpu.ops.pallas_kernels import threshold_encode_pallas
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu_torch import ComputationGraph as TGraph
from deeplearning4j_tpu_torch import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.convert import (conf_from_json,
                                              graph_conf_from_json,
                                              params_from_jax)
from deeplearning4j_tpu_torch.ops import threshold_encode as te
from deeplearning4j_tpu_torch.parallel import accumulation as tacc

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

TOL = 1e-10
_INT = {np.float64: (np.int64, torch.int64), np.float32: (np.int32,
                                                         torch.int32)}


def _bits_equal(t, j):
    """Bitwise equality of a torch tensor and a JAX array of one dtype."""
    a = np.asarray(j)
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        ni, ti = _INT[a.dtype.type]
        np.testing.assert_array_equal(t.view(ti).numpy(), a.view(ni))


def _inputs(n, dtype, threshold, seed=0):
    """(update, residual) float64 draws with the edge entries: at +-t,
    one ulp either side of t, NaN, +-inf and -0.0 (residual -0.0 there,
    so that acc is the entry itself)."""
    rng = np.random.RandomState(seed)
    upd = rng.randn(n) * threshold * 1.5
    res = rng.randn(n) * threshold * 0.5
    t = te.threshold_in(threshold, getattr(torch, dtype))
    tt = torch.tensor([t], dtype=getattr(torch, dtype))
    up = torch.nextafter(tt, torch.tensor([np.inf], dtype=tt.dtype)).item()
    down = torch.nextafter(tt, torch.tensor([0.0], dtype=tt.dtype)).item()
    edges = [t, -t, up, -up, down, -down, np.nan, np.inf, -np.inf, -0.0]
    k = min(n, len(edges))
    idx = rng.choice(n, size=k, replace=False)
    upd[idx] = edges[:k]
    res[idx] = -0.0
    return upd, res


def _jax_in(a, dtype):
    return jnp.asarray(a, jnp.float64).astype(dtype)


def _torch_in(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_plain_matches_pallas_kernel_and_inline_form(dtype, n):
    for thr in ((1e-3, 1e-5, 0.37) if n == 1000 else (1e-3,)):
        upd, res = _inputs(n, dtype, thr, seed=n)
        tm, tr = te.threshold_encode_plain(_torch_in(upd, dtype),
                                           _torch_in(res, dtype), thr)
        ju, jr = _jax_in(upd, dtype), _jax_in(res, dtype)
        pm, pr = threshold_encode_pallas(ju, jr, thr)
        with helpers_enabled_ctx(False):
            im, ir = jacc.threshold_encode(ju, jr, thr)
        for m, r in ((pm, pr), (im, ir)):
            _bits_equal(tm, m)
            _bits_equal(tr, r)
        t = te.threshold_in(thr, getattr(torch, dtype))
        assert set(np.unique(tm.numpy()).tolist()) <= {-t, 0.0, t}


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_plain_bf16_matches_inline_form(n):
    for thr in (1e-3, 1e-5, 0.37):
        upd, res = _inputs(n, "bfloat16", thr, seed=n + 1)
        # both sides round the same float32 values to bf16
        u32, r32 = upd.astype(np.float32), res.astype(np.float32)
        tm, tr = te.threshold_encode_plain(
            torch.from_numpy(u32).bfloat16(), torch.from_numpy(r32).bfloat16(),
            thr)
        with helpers_enabled_ctx(False):
            jm, jr = jacc.threshold_encode(
                jnp.asarray(u32).astype(jnp.bfloat16),
                jnp.asarray(r32).astype(jnp.bfloat16), thr)
        _bits_equal(tm, jm)
        # NaN stays in the residual in both; the CPU's bf16 rounding of a
        # NaN sum picks another NaN bit pattern in each framework
        nan = torch.isnan(tr).numpy()
        np.testing.assert_array_equal(nan,
                                      np.isnan(np.asarray(jr, np.float32)))
        _bits_equal(tr[~torch.from_numpy(nan)], np.asarray(jr)[~nan])
        t = te.threshold_in(thr, torch.bfloat16)
        assert set(np.unique(tm.float().numpy()).tolist()) <= {-t, 0.0, t}


def test_edge_semantics_and_shapes():
    t = te.threshold_in(1e-3, torch.float32)
    assert t == 0.0010000000474974513
    upd = torch.tensor([t, -t, np.nan, np.inf, -np.inf, -0.0, t / 2],
                       dtype=torch.float32)
    # a residual of -0.0 keeps acc = -0.0 + -0.0 at -0.0
    m, r = te.threshold_encode_plain(upd, torch.full_like(upd, -0.0), 1e-3)
    np.testing.assert_array_equal(m.numpy(), np.float32([t, -t, 0, t, -t, 0,
                                                         0]))
    assert not torch.signbit(m[5]) and torch.signbit(r[5])
    assert torch.isnan(r[2]) and r[3] == np.inf and r[4] == -np.inf
    # the accumulation module encodes any shape as its flat view
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5) * 1e-3)
    m2, r2 = tacc.threshold_encode(x, torch.zeros_like(x), 1e-3)
    mf, rf = te.threshold_encode_plain(x.reshape(-1),
                                       torch.zeros(15, dtype=x.dtype), 1e-3)
    assert m2.shape == (3, 5) and torch.equal(m2.reshape(-1), mf)
    assert torch.equal(r2.reshape(-1), rf)
    e = torch.zeros(0)
    assert [a.shape for a in tacc.threshold_encode(e, e, 1e-3)] == [(0,), (0,)]


# ------------------------------------------------------------ accumulators
def _store_sequence(np_dtype):
    rng = np.random.RandomState(3)
    return [[(rng.randn(300) * 2e-3).astype(np_dtype) for _ in range(3)]
            for _ in range(4)]


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_encoded_accumulator_matches_jax(np_dtype):
    """Three parties over four rounds, threshold decay 0.5 down to the
    1e-4 floor (reached in round 4), a reset before the last round."""
    kw = dict(parties=3, threshold=1e-3, threshold_decay=0.5,
              min_threshold=1e-4)
    ja, ta = jacc.EncodedGradientsAccumulator(**kw), \
        tacc.EncodedGradientsAccumulator(**kw)
    for rnd, stores in enumerate(_store_sequence(np_dtype)):
        if rnd == 3:
            ja.reset()
            ta.reset()
        for party, g in enumerate(stores):
            ja.store_update(jnp.asarray(g), party=party)
            ta.store_update(torch.from_numpy(g), party=party)
        _bits_equal(ta.get_update(), ja.get_update())
        assert ta.threshold == ja.threshold
        for party in range(3):
            _bits_equal(ta._residuals[party], ja._residuals[party])
    assert ta.threshold == 1e-4
    with pytest.raises(ValueError):
        ta.get_update()


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_basic_accumulator_matches_jax(np_dtype):
    ja, ta = jacc.BasicGradientsAccumulator(3), \
        tacc.BasicGradientsAccumulator(3)
    for stores in _store_sequence(np_dtype)[:2]:
        for party, g in enumerate(stores):
            ja.store_update(jnp.asarray(g), party=party)
            ta.store_update(torch.from_numpy(g), party=party)
        _bits_equal(ta.get_update(), ja.get_update())
    ta.store_update(torch.ones(2))
    ta.reset()
    with pytest.raises(ValueError):
        ta.get_update()


# --------------------------------------------- networks with an accumulator
def _mlp():
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .weight_init(WeightInit.XAVIER).activation(Activation.TANH)
            .updater(Adam(learning_rate=0.05)).dtype("float64").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(5)).build())
    j = MultiLayerNetwork(conf).init()
    return j, TNet(conf_from_json(j.conf.to_json()), device="cpu").init(
        params_from_jax(j.params_tree, device="cpu"))


def _graph():
    g = (NeuralNetConfiguration.Builder().seed(2)
         .weight_init(WeightInit.XAVIER).activation(Activation.TANH)
         .updater(Adam(learning_rate=0.05)).dtype("float64").graph_builder())
    (g.add_inputs("in")
      .add_layer("d1", DenseLayer(n_out=8), "in")
      .add_layer("bn", BatchNormalization(), "d1")
      .add_layer("out", OutputLayer(n_out=3, activation=Activation.SOFTMAX),
                 "bn")
      .set_outputs("out")
      .set_input_types(InputType.feed_forward(5)))
    j = ComputationGraph(g.build()).init()
    return j, TGraph(graph_conf_from_json(j.conf.to_json()),
                     device="cpu").init(params_from_jax(j.params_tree,
                                                        device="cpu"))


@pytest.mark.parametrize("kind", ["encoded", "basic"])
@pytest.mark.parametrize("net", ["mlp", "graph"])
def test_fit_with_gradients_accumulator_matches_jax(net, kind):
    jnet, tnet = (_mlp if net == "mlp" else _graph)()
    if kind == "encoded":
        kw = dict(threshold=1e-3, threshold_decay=0.9, min_threshold=5e-4)
        ja, ta = jacc.EncodedGradientsAccumulator(**kw), \
            tacc.EncodedGradientsAccumulator(**kw)
    else:
        ja, ta = jacc.BasicGradientsAccumulator(), \
            tacc.BasicGradientsAccumulator()
    jnet.set_gradients_accumulator(ja)
    tnet.set_gradients_accumulator(ta)
    rng = np.random.RandomState(7)
    for _ in range(3):
        x = rng.randn(8, 5)
        y = np.eye(3)[rng.randint(0, 3, 8)]
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert tnet._step == jnet._step == 3
    np.testing.assert_allclose(tnet.params().numpy(),
                               np.asarray(jnet.params()), atol=TOL, rtol=0)
    np.testing.assert_allclose(tnet.get_updater_state_view().numpy(),
                               np.asarray(jnet.get_updater_state_view()),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tnet.score(), float(jnet.score()), atol=TOL)
    if kind == "encoded":
        assert ta.threshold == ja.threshold
        np.testing.assert_allclose(ta._residuals[0].numpy(),
                                   np.asarray(ja._residuals[0]), atol=TOL,
                                   rtol=0)
    # removing the accumulator restores the plain step
    tnet.set_gradients_accumulator(None)
    tnet.fit(x, y)
    assert tnet._step == 4
