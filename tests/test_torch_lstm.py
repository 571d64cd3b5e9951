"""LSTM training and streaming in the port against the JAX package, in
float64 on the CPU.

The networks (GravesLSTM(16) x 2 + RnnOutputLayer, RmsProp, l2, non-zero
peepholes) are built from one configuration JSON with `conf_from_json` /
`params_from_jax`: truncated BPTT through `fit`, the whole-sequence
`fit_batch` (with the final recurrent states it returns) and
`fit_on_device` of a TruncatedBPTT configuration, masked training, the
RmsProp state carried over, `rnn_time_step`, and the zoo
`TextGenerationLSTM` configuration. Tolerance 1e-9.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import (Activation, InputType, MultiLayerNetwork,
                                NeuralNetConfiguration, WeightInit)
from deeplearning4j_tpu.common.enums import BackpropType
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import TextGenerationLSTM as JTextGen
from deeplearning4j_tpu.nn.conf.layers import recurrent as jrec
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu_torch import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.convert import (conf_from_json,
                                              opt_state_from_jax,
                                              params_from_jax)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import TextGenerationLSTM as TTextGen
from deeplearning4j_tpu_torch.util.flat_params import tree_leaves

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

NET_TOL = 1e-9
V, TN, BN, HN = 5, 12, 4, 16


def _conf(tbptt=True, layer=jrec.GravesLSTM, updater=None, dtype="float64",
          compute_dtype=None, bidirectional=False):
    b = (NeuralNetConfiguration.Builder().seed(4).l2(1e-3)
         .weight_init(WeightInit.XAVIER)
         .updater(updater or jupd.RmsProp(learning_rate=0.01)).dtype(dtype))
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    b = b.list().layer(layer(n_out=HN, activation=Activation.TANH))
    b.layer(jrec.GravesBidirectionalLSTM(n_out=HN) if bidirectional
            else layer(n_out=HN, activation=Activation.TANH))
    b.layer(jrec.RnnOutputLayer(n_out=V, activation=Activation.SOFTMAX))
    b = b.set_input_type(InputType.recurrent(V))
    if tbptt:
        b = (b.backprop_type(BackpropType.TruncatedBPTT)
             .t_bptt_forward_length(5).t_bptt_backward_length(5))
    return b.build()


def _pair(**kw):
    net = MultiLayerNetwork(_conf(**kw)).init()
    # non-zero peepholes, so the peephole terms are exercised
    net.params_tree = [{k: v + 0.2 * jnp.cos(jnp.arange(v.size) * 0.7)
                        if k[:2] in ("pi", "pf", "po") else v
                        for k, v in p.items()} for p in net.params_tree]
    tnet = TNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))
    return net, tnet


def _data(seed, steps=None, masked=False):
    rng = np.random.RandomState(seed)
    lead = (steps,) if steps else ()
    idx = rng.randint(0, V, lead + (BN, TN))
    x = np.moveaxis(np.eye(V)[idx], -1, -2)            # (..., B, V, T)
    y = np.moveaxis(np.eye(V)[np.roll(idx, -1, axis=-1)], -1, -2)
    mask = None
    if masked:
        lengths = rng.randint(3, TN + 1, lead + (BN,))
        mask = (np.arange(TN) < lengths[..., None]).astype(np.float64)
    return x, y, mask


def _same_params(net, tnet, tol=NET_TOL):
    for i, (jp, tp) in enumerate(zip(net.params_tree, tnet.params_tree)):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=tol, rtol=0,
                                       err_msg=f"layer {i} {k}")


def _same_states(final, jfinal, tol=NET_TOL):
    assert len(final) == len(jfinal)
    for s, js in zip(final, jfinal):
        if js is None:
            assert s is None
            continue
        for a, ja in zip(s, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=tol,
                                       rtol=0)


def test_tbptt_fit_matches_jax():
    """fit over two batches of T 12 with tBPTT length 5 (segments 5, 5, 2):
    RmsProp, l2, the state carried and detached between segments."""
    net, tnet = _pair()
    batches = [_data(seed) for seed in (1, 2)]
    net.fit([JDataSet(x, y) for x, y, _ in batches])
    tnet.fit([TDataSet(x, y) for x, y, _ in batches])
    _same_params(net, tnet)
    assert tnet._step == net._step == 6
    np.testing.assert_allclose(tnet.score(), net.score(), atol=NET_TOL)


def test_tbptt_segments_carry_final_states_like_jax():
    """The segment loop by hand: fit_batch on each tBPTT segment from the
    previous segment's final states, params and final_rnn against JAX."""
    net, tnet = _pair()
    x, y, _ = _data(5)
    carry, tcarry = None, None
    for start in range(0, TN, 5):
        sl = slice(start, min(start + 5, TN))
        final = net.fit_batch(x[:, :, sl], y[:, :, sl],
                              rnn_init_states=carry)
        tfinal = tnet.fit_batch(x[:, :, sl], y[:, :, sl],
                                rnn_init_states=tcarry)
        _same_states(tfinal, final)
        assert all(not t.requires_grad for s in tfinal for t in s)
        carry, tcarry = final, tfinal
    _same_params(net, tnet)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_fit_batch_runs_tbptt_conf_on_whole_sequence(bidirectional):
    """fit_batch of a TruncatedBPTT configuration is one step on the whole
    sequence and returns each LSTM layer's final (h, c), None for a
    bidirectional one."""
    net, tnet = _pair(bidirectional=bidirectional)
    x, y, _ = _data(9)
    final = net.fit_batch(x, y)
    tfinal = tnet.fit_batch(x, y)
    _same_states(tfinal, final)
    assert (tfinal[1] is None) == bidirectional
    _same_params(net, tnet)
    np.testing.assert_allclose(tnet.score(), net.score(), atol=NET_TOL)


@pytest.mark.parametrize("per_step", [False, True])
def test_fit_on_device_runs_tbptt_conf_on_whole_sequence(per_step):
    net, tnet = _pair()
    if per_step:
        x, y, _ = _data(3, steps=2)
        args = {}
    else:
        x, y, _ = _data(3)
        args = {"steps": 2}
    losses = net.fit_on_device(x, y, **args)
    tlosses = tnet.fit_on_device(x, y, **args)
    np.testing.assert_allclose(tlosses, np.asarray(losses), atol=NET_TOL)
    _same_params(net, tnet)
    for a, b in zip(tree_leaves(tnet._opt_state),
                    jax.tree_util.tree_leaves(net._opt_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=NET_TOL)


@pytest.mark.parametrize("layer", [jrec.GravesLSTM, jrec.LSTM],
                         ids=["graves_gates", "lstm_gates"])
def test_masked_fit_batch_matches_jax(layer):
    """Masked sequences take the per-step loop (the K8 / K9 cells)."""
    net, tnet = _pair(layer=layer, tbptt=False)
    x, y, m = _data(13, masked=True)
    for _ in range(2):
        final = net.fit_batch(x, y, m, m)
        tfinal = tnet.fit_batch(x, y, m, m)
        _same_states(tfinal, final)
    _same_params(net, tnet)


def test_resume_carries_rmsprop_state():
    """opt_state_from_jax carries the RmsProp state: a port network
    resumed from a JAX network's params and updater state steps like it."""
    net, _ = _pair(tbptt=False)
    x, y, _ = _data(21)
    net.fit_batch(x, y)
    tnet = TNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))
    tnet._opt_state = opt_state_from_jax(net._opt_state, device="cpu")
    tnet._step = net._step
    net.fit_batch(x, y)
    tnet.fit_batch(x, y)
    _same_params(net, tnet)


def test_rnn_time_step_matches_jax_and_output():
    net, tnet = _pair(tbptt=False)
    x, _, _ = _data(17)
    for t in range(6):
        out = tnet.rnn_time_step(x[:, :, t])
        ref = net.rnn_time_step(x[:, :, t])
        assert tuple(out.shape) == (BN, V)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=NET_TOL, rtol=0)
        full = tnet.output(x[:, :, :t + 1])
        np.testing.assert_allclose(out.numpy(), full[:, :, -1].numpy(),
                                   atol=NET_TOL, rtol=0)
    # a (batch, size, time) chunk continues the stream
    out = tnet.rnn_time_step(x[:, :, 6:9])
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(net.rnn_time_step(x[:, :, 6:9])),
                               atol=NET_TOL, rtol=0)
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, :, 0]).numpy(),
                               tnet.output(x[:, :, :1])[:, :, 0].numpy(),
                               atol=NET_TOL, rtol=0)


def test_rnn_time_step_refuses_bidirectional_layer():
    _, tnet = _pair(tbptt=False, bidirectional=True)
    with pytest.raises(ValueError, match="layer 1.*GravesBidirectionalLSTM"):
        tnet.rnn_time_step(np.zeros((BN, V)))


def test_mixed_precision_carries_states_in_compute_dtype():
    """bf16 compute over float32 params: the carried states are cast to
    the compute dtype and come back in it, and the loss stays finite."""
    _, tnet = _pair(dtype="float32", compute_dtype="bfloat16")
    x, y, _ = _data(23)
    final = tnet.fit_batch(x, y)
    assert all(t.dtype == torch.bfloat16 for s in final for t in s)
    final = tnet.fit_batch(x, y, rnn_init_states=[
        tuple(t.float() for t in s) for s in final])
    assert all(t.dtype == torch.bfloat16 for s in final for t in s)
    assert np.isfinite(tnet.score())


def test_text_generation_lstm_conf_matches_jax():
    for kw in ({}, {"total_unique_characters": 30, "seed": 9,
                    "compute_dtype": "bfloat16"}):
        assert json.loads(TTextGen(**kw).conf().to_json()) == \
            json.loads(JTextGen(**kw).conf().to_json())
    conf = conf_from_json(JTextGen().conf().to_json())
    assert conf.backprop_type.value == "truncated_bptt"
    assert conf.tbptt_fwd_length == 50
