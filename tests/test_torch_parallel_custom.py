"""The port's ParallelWrapper in CUSTOM mode against the JAX package's on
the CPU: an MLP and a small graph with a BatchNormalization, float64,
Adam, an EncodedGradientsAccumulator, three steps at workers 1 and 4;
params, updater state, running statistics, score and every party's
residual within 1e-10. Also the invariant of the JAX package's
test_custom_mode_matches_single_device_sgd: CUSTOM with a
BasicGradientsAccumulator and plain SGD steps as one network on the whole
batch.

The JAX wrapper's CUSTOM step runs its per-replica gradient shard_map
eagerly, 5-10 s a step on the CPU; here `jax.jit` compiles that same
shard_map (the `jax_jit_shard_map` fixture wraps the wrapper module's
`compat_shard_map` for the test's duration), which computes the same
function in about a second a run. The other modes are in
tests/test_torch_parallel_wrapper.py.
"""
import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.parallel.parallel_wrapper as jax_pw
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.parallel import (BasicGradientsAccumulator,
                                               EncodedGradientsAccumulator,
                                               ParallelWrapper, TrainingMode,
                                               make_mesh)
from deeplearning4j_tpu_torch.util.flat_params import flatten_params
from test_torch_parallel_wrapper import (TOL, _data, _graph, _mlp,
                                         _wrappers, assert_matches)


@pytest.fixture
def jax_jit_shard_map(monkeypatch):
    shard_map = jax_pw.compat_shard_map
    monkeypatch.setattr(jax_pw, "compat_shard_map",
                        lambda *a, **kw: jax.jit(shard_map(*a, **kw)))


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("net", ["mlp", "graph"])
def test_custom_matches_jax(net, workers, jax_jit_shard_map):
    jnet, tnet = (_mlp if net == "mlp" else _graph)()
    kw = dict(parties=workers, threshold=1e-3, threshold_decay=0.9)
    ja, ta = jacc.EncodedGradientsAccumulator(**kw), \
        EncodedGradientsAccumulator(**kw)
    jw, tw = _wrappers(jnet, tnet, workers, TrainingMode.CUSTOM, (ja, ta))
    for step in range(3):
        x, y = _data(seed=10 + step)
        jw.fit(x, y)
        tw.fit(x, y)
        assert_matches(jnet, tnet, jw, tw)
        assert ta.threshold == ja.threshold
        for party in range(workers):
            np.testing.assert_allclose(ta._residuals[party].numpy(),
                                       np.asarray(ja._residuals[party]),
                                       atol=TOL, rtol=0)


def _sgd(net):
    net._updaters = [tupd.Sgd(learning_rate=0.1) for _ in net.layers]
    net._opt_state = [u.init(p) for u, p in zip(net._updaters,
                                                net.params_tree)]
    return net


def test_custom_basic_sgd_matches_single_device_step():
    """The mean of the four shards' gradients is the whole batch's, so
    plain SGD on it is one fit_batch of the whole batch."""
    _, net_a = _mlp(seed=7)
    _, net_b = _mlp(seed=7)
    _sgd(net_a)
    _sgd(net_b)
    tw = ParallelWrapper(net_a, mesh=make_mesh(4, device="cpu"),
                         training_mode=TrainingMode.CUSTOM,
                         accumulator=BasicGradientsAccumulator())
    for step in range(2):
        x, y = _data(32, seed=step)
        tw.fit(x, y)
        net_b.fit_batch(x, y)
        np.testing.assert_allclose(net_a.params().numpy(),
                                   net_b.params().numpy(), atol=TOL, rtol=0)
        for r in range(1, 4):
            assert torch.equal(flatten_params(tw._params[r]),
                               flatten_params(tw._params[0]))
