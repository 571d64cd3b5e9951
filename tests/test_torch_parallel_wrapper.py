"""The port's ParallelWrapper (SHARED_GRADIENTS and AVERAGING), its mesh
and the dataset iterators, against the JAX package on the CPU.

Both wrappers train one float64 network from the same parameters and
data: the JAX one on the 8-virtual-device CPU mesh (tests/conftest.py),
the port's on `make_mesh(R, device="cpu")`, R replicas on the CPU. An MLP
and a small graph with a BatchNormalization, at workers 1 and 4, three
steps: params, updater state, BatchNormalization state and score within
1e-10, and the port's replicas bitwise identical after each step. CUSTOM
mode is in tests/test_torch_parallel_custom.py.
"""
import numpy as np
import pytest

import torch

from deeplearning4j_tpu import (Activation, Adam, DenseLayer, InputType,
                                MultiLayerNetwork, NeuralNetConfiguration,
                                OutputLayer, WeightInit)
from deeplearning4j_tpu.datasets import iterators as jit_
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu.nn.graph.computation_graph import ComputationGraph
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel.parallel_wrapper import \
    ParallelWrapper as JWrapper
from deeplearning4j_tpu_torch import ComputationGraph as TGraph
from deeplearning4j_tpu_torch import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.convert import (conf_from_json,
                                              graph_conf_from_json,
                                              params_from_jax)
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.dataset import \
    MultiDataSet as TMultiDataSet
from deeplearning4j_tpu_torch.parallel import (BasicGradientsAccumulator,
                                               EncodedGradientsAccumulator,
                                               ParallelWrapper, TrainingMode,
                                               make_mesh)
from deeplearning4j_tpu_torch.util.flat_params import flatten_params

TOL = 1e-10


def _mlp(seed=3):
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .weight_init(WeightInit.XAVIER).activation(Activation.TANH)
            .updater(Adam(learning_rate=0.05)).dtype("float64").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(5)).build())
    j = MultiLayerNetwork(conf).init()
    return j, TNet(conf_from_json(j.conf.to_json()), device="cpu").init(
        params_from_jax(j.params_tree, device="cpu"))


def _graph():
    """in(5) -> Dense(8) -> BatchNormalization -> Output(3)."""
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


def _data(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 5), np.eye(3)[rng.randint(0, 3, n)]


def _wrappers(jnet, tnet, workers, mode, accumulators=None, **kw):
    ja, ta = accumulators or (None, None)
    jw = JWrapper(jnet, workers=workers, training_mode=mode, accumulator=ja,
                  **kw)
    tw = ParallelWrapper(tnet, mesh=make_mesh(workers, device="cpu"),
                         training_mode=mode, accumulator=ta, **kw)
    return jw, tw


def _states(net):
    return np.concatenate([np.asarray(s[k], np.float64).ravel()
                           for s in net.state_tree for k in sorted(s)]
                          or [np.zeros(0)])


def assert_matches(jnet, tnet, jw, tw):
    """The wrapped networks agree (params, updater state, layer state,
    step) and so do the scores; the port's replicas hold identical params
    (and updater states, except in SHARED_GRADIENTS, where each replica
    steps its own updater on its own gradients)."""
    assert tnet._step == jnet._step
    for got, want in (
            (tnet.params(), jnet.params()),
            (tnet.get_updater_state_view(), jnet.get_updater_state_view())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    np.testing.assert_allclose(
        np.concatenate([t.numpy().ravel() for s in tnet.state_tree
                        for _, t in sorted(s.items())] or [np.zeros(0)]),
        _states(jnet), atol=TOL, rtol=0)
    np.testing.assert_allclose(tw.score(), jw.score(), atol=TOL, rtol=0)
    p0 = flatten_params(tw._params[0])
    for r in range(1, tw.workers):
        assert torch.equal(flatten_params(tw._params[r]), p0)
        if tw.training_mode != TrainingMode.SHARED_GRADIENTS:
            assert torch.equal(flatten_params(tw._opt[r]),
                               flatten_params(tw._opt[0]))


MODES = {"shared_gradients": dict(training_mode=TrainingMode.SHARED_GRADIENTS),
         "averaging": dict(training_mode=TrainingMode.AVERAGING),
         # three steps in windows of two: the partial last window is
         # averaged on the write-back
         "averaging_af2": dict(training_mode=TrainingMode.AVERAGING,
                               averaging_frequency=2)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("net", ["mlp", "graph"])
def test_wrapper_matches_jax(net, workers, mode):
    jnet, tnet = (_mlp if net == "mlp" else _graph)()
    kw = dict(MODES[mode])
    jw, tw = _wrappers(jnet, tnet, workers, kw.pop("training_mode"), **kw)
    for step in range(3):
        x, y = _data(seed=step)
        jw.fit(x, y)
        tw.fit(x, y)
        assert_matches(jnet, tnet, jw, tw)
    if tw.training_mode == TrainingMode.SHARED_GRADIENTS:
        # one residual per replica, each leaf its own
        assert len(tw._residual) == workers
        assert not torch.equal(flatten_params(tw._residual[0]),
                               torch.zeros(tnet.num_params(),
                                           dtype=torch.float64))


def test_fit_on_device_matches_jax():
    jnet, tnet = _graph()
    jw, tw = _wrappers(jnet, tnet, 4, TrainingMode.SHARED_GRADIENTS)
    x, y = _data()
    jl = jw.fit_on_device(x, y, steps=3)
    tl = tw.fit_on_device(x, y, steps=3)
    assert isinstance(tl, np.ndarray) and tl.shape == (3,)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL, rtol=0)
    assert_matches(jnet, tnet, jw, tw)
    jl = jw.fit_on_device(x, y, steps=2, sync=False)
    tl = tw.fit_on_device(x, y, steps=2, sync=False)
    assert isinstance(tl, torch.Tensor) and tnet._step == 5
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert_matches(jnet, tnet, jw, tw)


def test_fit_over_iterators_and_multi_dataset():
    """fit over a ListDataSetIterator (two epochs, prefetched) and over
    a MultiDataSet, against the JAX package; the write-back sets the
    step and `output` serves the trained params."""
    jnet, tnet = _graph()
    jw, tw = _wrappers(jnet, tnet, 4, TrainingMode.SHARED_GRADIENTS,
                       prefetch_buffer=1)
    x, y = _data(32, seed=5)
    jw.fit(jit_.ListDataSetIterator([JDataSet(x, y)], batch=16), epochs=2)
    tw.fit(tit.ListDataSetIterator([TDataSet(x, y)], batch=16), epochs=2)
    assert tnet._step == 4
    assert_matches(jnet, tnet, jw, tw)
    jw.fit(JMultiDataSet([x[:8]], [y[:8]]))
    tw.fit(TMultiDataSet([x[:8]], [y[:8]]))
    assert_matches(jnet, tnet, jw, tw)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=TOL, rtol=0)


def test_raises():
    _, tnet = _mlp()
    with pytest.raises(ValueError, match="GradientsAccumulator"):
        ParallelWrapper(tnet, workers=2, training_mode=TrainingMode.CUSTOM)
    with pytest.raises(ValueError, match="Unknown training mode"):
        ParallelWrapper(tnet, workers=2, training_mode="async")
    tw = ParallelWrapper(tnet, workers=2, training_mode=TrainingMode.CUSTOM,
                         accumulator=BasicGradientsAccumulator())
    x, y = _data(8)
    with pytest.raises(ValueError, match="CUSTOM"):
        tw.fit_on_device(x, y, steps=1)
    tw = ParallelWrapper(tnet, workers=4)
    x, y = _data(10)
    with pytest.raises(ValueError, match="not divisible"):
        tw.fit(x, y)
    assert tnet._step == 0
    with pytest.raises(ValueError, match="not divisible"):
        tw.fit_on_device(x, y, steps=1)


def test_make_mesh(monkeypatch):
    assert make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)                   # the card by default, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="Requested 3 devices, have 2"):
        make_mesh(3)
    assert make_mesh().devices == (torch.device("cuda", 0),
                                   torch.device("cuda", 1))


def test_builder_mesh_listeners_and_write_back():
    _, tnet = _mlp()
    acc = EncodedGradientsAccumulator(parties=2)
    tw = (ParallelWrapper.Builder(tnet).workers(2).prefetchBuffer(3)
          .averagingFrequency(5).trainingMode(TrainingMode.CUSTOM)
          .gradients_threshold(5e-3).reportScoreAfterAveraging(False)
          .workspace_mode("ENABLED").gradientsAccumulator(acc).build())
    assert (tw.workers, tw.prefetch_buffer, tw.averaging_frequency,
            tw.training_mode, tw.gradients_threshold,
            tw.report_score_after_averaging, tw.accumulator) == \
        (2, 3, 5, TrainingMode.CUSTOM, 5e-3, False, acc)
    assert tw.mesh.devices == (torch.device("cpu"),) * 2
    mesh = make_mesh(3, device="cpu")
    tw = ParallelWrapper.Builder(tnet).mesh(mesh).build()
    assert tw.workers == 3 and tw.mesh is mesh
    assert tw.training_mode == TrainingMode.SHARED_GRADIENTS
    seen = []

    class Listener:
        def iteration_done(self, model, step):
            seen.append((model, step))
    tw.set_listeners(Listener())
    x, y = _data(12)
    before = tnet.params().clone()
    tw.fit(x, y)
    tw.fit(TDataSet(x, y))
    assert seen == [(tw, 1), (tw, 2)] and tnet._step == 2
    assert torch.equal(tnet.params(), flatten_params(tw._params[0]))
    assert not torch.equal(tnet.params(), before)
    assert torch.equal(tnet.get_updater_state_view(),
                       flatten_params(tw._opt[0]))
    assert np.isfinite(tw.score())
    tw.shutdown()
    assert tw._params is None
    tw.fit(x, y)                       # a fresh setup from the network
    assert tnet._step == 3


# --------------------------------------------------------------- iterators
def _batches(it):
    return [(np.asarray(d.features), np.asarray(d.labels)) for d in it]


def _same(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def test_iterators_match_jax():
    x, y = _data(20, seed=9)
    jd, td = JDataSet(x, y), TDataSet(x, y)
    pairs = [
        (jit_.ListDataSetIterator([jd], batch=6),
         tit.ListDataSetIterator([td], batch=6)),
        (jit_.INDArrayDataSetIterator(x, y, 8),
         tit.INDArrayDataSetIterator(x, y, 8)),
        (jit_.ExistingDataSetIterator([jd, jd]),
         tit.ExistingDataSetIterator([td, td])),
        (jit_.EarlyTerminationDataSetIterator(
            jit_.INDArrayDataSetIterator(x, y, 4), 2),
         tit.EarlyTerminationDataSetIterator(
            tit.INDArrayDataSetIterator(x, y, 4), 2)),
        (jit_.MultipleEpochsIterator(2, jit_.INDArrayDataSetIterator(x, y, 7)),
         tit.MultipleEpochsIterator(2, tit.INDArrayDataSetIterator(x, y, 7))),
        (jit_.SamplingDataSetIterator(jd, 6, 15, seed=4),
         tit.SamplingDataSetIterator(td, 6, 15, seed=4)),
        (jit_.BenchmarkDataSetIterator((5, 3), 4, 2, seed=1),
         tit.BenchmarkDataSetIterator((5, 3), 4, 2, seed=1)),
        (jit_.AsyncDataSetIterator(jit_.INDArrayDataSetIterator(x, y, 3), 2,
                                   device_prefetch=False),
         tit.AsyncDataSetIterator(tit.INDArrayDataSetIterator(x, y, 3), 2))]
    for j, t in pairs:
        for _ in range(2):                 # a second pass after reset()
            j.reset()
            t.reset()
            _same(_batches(t), _batches(j))
    lj, lt = pairs[0]
    assert (lt.batch(), len(lt)) == (lj.batch(), len(lj)) == (6, 4)
    assert tit.AsyncDataSetIterator.async_supported is False
    assert tit.DataSetIterator().batch() == -1


def test_async_iterator_errors_and_early_stop():
    def broken():
        yield TDataSet(np.zeros((2, 1)), np.zeros((2, 1)))
        raise KeyError("underlying failed")
    it = tit.AsyncDataSetIterator(tit.ExistingDataSetIterator(broken()), 1)
    with pytest.raises(KeyError, match="underlying failed"):
        list(it)
    x, y = _data(64)
    it = tit.AsyncDataSetIterator(tit.INDArrayDataSetIterator(x, y, 1), 2)
    for i, _ in enumerate(it):        # the consumer stops early
        if i == 1:
            break
    assert len(list(it)) == 64         # and a new pass starts over


def test_accumulator_modules_are_exported():
    from deeplearning4j_tpu_torch import parallel
    import deeplearning4j_tpu_torch as pkg
    assert pkg.ParallelWrapper is ParallelWrapper
    assert pkg.EncodedGradientsAccumulator is EncodedGradientsAccumulator
    assert set(parallel.__all__) >= {"ParallelWrapper", "TrainingMode",
                                     "make_mesh", "threshold_encode",
                                     "GradientsAccumulator"}
    assert issubclass(EncodedGradientsAccumulator,
                      parallel.GradientsAccumulator)
    assert jacc.EncodedGradientsAccumulator().threshold == \
        EncodedGradientsAccumulator().threshold == 1e-3
