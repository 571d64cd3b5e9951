"""The port's convolutional, pooling, normalization and feed-forward layers
and the input preprocessors against the JAX package's, on the CPU.

Each layer is built in the JAX package, carried over by its dict
(`BaseLayerConf.from_dict(layer.to_dict())`) and run on the same numpy
draws: the forward and the gradients of one numpy cotangent with respect
to the input and every parameter, in float64 within 1e-10. BatchNorm runs
in training (with its running-state update) and at inference, in float64
and in bfloat16 (within bf16's 2^-7 relative). The zoo LeNet and
SimpleCNN MultiLayerNetworks: their configurations equal the JAX
package's, and their forwards agree within 1e-9.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.common.enums import (Activation, ConvolutionMode,
                                             PoolingType)
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.input_type import InputType
from deeplearning4j_tpu.nn.conf.layers.convolutional import (
    ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu.nn.conf.layers.feedforward import (DenseLayer,
                                                           EmbeddingLayer,
                                                           OutputLayer)
from deeplearning4j_tpu.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu.models.lenet import LeNet as JaxLeNet
from deeplearning4j_tpu.models.simple_cnn import SimpleCNN as JaxSimpleCNN
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch import MultiLayerNetwork as TorchNet
from deeplearning4j_tpu_torch.convert import conf_from_json, params_from_jax
from deeplearning4j_tpu_torch.models import LeNet, SimpleCNN
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf.input_type import \
    InputType as TorchInputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf
from test_torch_graph import _init_from_port

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

TOL = 1e-10


def _port(layer):
    return BaseLayerConf.from_dict(layer.to_dict())


def _params(layer, in_type, seed):
    p = layer.init_params(jax.random.PRNGKey(seed), in_type, jnp.float64) \
        if layer.has_params() else {}
    rng = np.random.RandomState(seed)
    # random draws for every param (biases and BN's gamma/beta included)
    return {k: rng.randn(*v.shape) * 0.5 + (1.0 if k == "gamma_w" else 0.0)
            for k, v in p.items()}


def _compare(layer, x, in_type, *, train=False, mask=None, seed=0,
             state=None, tol=TOL):
    """Forward and input/param gradients of `layer` in both packages."""
    tl = _port(layer)
    p = _params(layer, in_type, seed)
    st = state or {}
    jm = None if mask is None else jnp.asarray(mask)

    def jf(x, p):
        out, ns, _ = layer.forward(p, {k: jnp.asarray(v) for k, v in
                                       st.items()}, x, train=train, mask=jm)
        return out, ns

    @jax.jit
    def fwd_bwd(x, p, cot):             # one compile instead of many ops
        (o, ns), vjp = jax.vjp(jf, x, p)
        return o, ns, vjp((cot, jax.tree_util.tree_map(jnp.zeros_like, ns)))
    jx = jnp.asarray(x)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    out_shape = jax.eval_shape(jf, jx, jparams)[0].shape
    cot = np.random.RandomState(seed + 1).randn(*out_shape)
    jo, jns, (jdx, jdp) = fwd_bwd(jx, jparams, jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    to, tns, _ = tl.forward(tp, {k: torch.from_numpy(np.asarray(v)) for k, v
                                 in st.items()}, tx, train=train,
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=tol)
    for k in jns:
        np.testing.assert_allclose(tns[k].detach().numpy(),
                                   np.asarray(jns[k]), rtol=0, atol=tol)
    grads = torch.autograd.grad(to, [tx] + list(tp.values()),
                                torch.from_numpy(cot))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), rtol=0,
                               atol=tol)
    for g, k in zip(grads[1:], tp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jdp[k]), rtol=0,
                                   atol=tol, err_msg=k)
    return to


CONV = [
    dict(kernel_size=(3, 3), convolution_mode=ConvolutionMode.Truncate),
    dict(kernel_size=(3, 3), padding=(1, 2), stride=(2, 1),
         convolution_mode=ConvolutionMode.Truncate),
    dict(kernel_size=(3, 2), stride=(2, 2),
         convolution_mode=ConvolutionMode.Same),
    dict(kernel_size=(3, 3), dilation=(2, 2),
         convolution_mode=ConvolutionMode.Same),
    dict(kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
         convolution_mode=ConvolutionMode.Strict),
    dict(kernel_size=(1, 1), stride=(2, 2), has_bias=False),
]


@pytest.mark.parametrize("kw", CONV, ids=range(len(CONV)))
def test_convolution_matches_jax(kw):
    it = InputType.convolutional(7, 7, 3)
    layer = ConvolutionLayer(n_in=3, n_out=4, activation=Activation.TANH,
                             **kw)
    out = _compare(layer, np.random.RandomState(1).randn(2, 3, 7, 7), it)
    ot = layer.get_output_type(it)
    assert _port(layer).get_output_type(TorchInputType.convolutional(
        7, 7, 3)) == TorchInputType(**ot.to_dict())
    assert tuple(out.shape) == (2, 4, ot.height, ot.width)


def test_strict_mode_rejects_a_ragged_stride():
    layer = _port(ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 3),
                                   stride=(2, 2),
                                   convolution_mode=ConvolutionMode.Strict))
    with pytest.raises(ValueError, match="Strict"):
        layer.get_output_type(TorchInputType.convolutional(6, 6, 3))


@pytest.mark.parametrize("pt", list(PoolingType), ids=lambda p: p.value)
@pytest.mark.parametrize("mode", [ConvolutionMode.Same,
                                  ConvolutionMode.Truncate],
                         ids=lambda m: m.value)
def test_pooling_matches_jax(pt, mode):
    layer = SubsamplingLayer(pooling_type=pt, kernel_size=(3, 3),
                             stride=(2, 2), convolution_mode=mode, pnorm=3)
    x = np.random.RandomState(2).randn(2, 3, 7, 6)
    if pt == PoolingType.PNORM:
        x = np.abs(x) + 0.1                   # |x|^p is smooth away from 0
    _compare(layer, x, InputType.convolutional(7, 6, 3))


def test_zero_padding_matches_jax():
    _compare(ZeroPaddingLayer(pad=(1, 2, 0, 3)),
             np.random.RandomState(3).randn(2, 3, 4, 4),
             InputType.convolutional(4, 4, 3))


@pytest.mark.parametrize("pt", list(PoolingType), ids=lambda p: p.value)
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_matches_jax(pt, masked):
    rng = np.random.RandomState(4)
    layer = GlobalPoolingLayer(pooling_type=pt, pnorm=2)
    x = np.abs(rng.randn(3, 4, 6)) + 0.1
    mask = None
    if masked:
        mask = (rng.rand(3, 6) > 0.3).astype(np.float64)
        mask[:, 0] = 1.0
    _compare(layer, x, InputType.recurrent(4), mask=mask)
    _compare(layer, np.abs(rng.randn(2, 3, 4, 5)) + 0.1,
             InputType.convolutional(4, 5, 3))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 3)])
def test_batchnorm_matches_jax_fp64(train, shape):
    rng = np.random.RandomState(5)
    n = shape[1]
    layer = BatchNormalization(n_in=n, n_out=n, decay=0.8,
                               activation=Activation.RELU)
    state = {"mean": rng.randn(n), "var": rng.rand(n) + 0.5}
    it = InputType.convolutional(5, 5, n) if len(shape) == 4 \
        else InputType.feed_forward(n)
    _compare(layer, rng.randn(*shape) * 2.0 + 1.0, it, train=train,
             state=state)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax_bf16(train):
    """bf16 activations: one-pass fp32 statistics cast to bf16 before the
    normalize (training), the fp32 running state at inference."""
    rng = np.random.RandomState(6)
    n = 4
    layer = BatchNormalization(n_in=n, n_out=n)
    x = rng.randn(3, n, 4, 4) + 2.0
    mean, var = rng.randn(n), rng.rand(n) + 0.5
    gamma, beta = rng.randn(n), rng.randn(n)
    jx = jnp.asarray(x, jnp.bfloat16)
    jo, jns, _ = layer.forward(
        {"gamma_w": jnp.asarray(gamma, jnp.bfloat16),
         "beta": jnp.asarray(beta, jnp.bfloat16)},
        {"mean": jnp.asarray(mean, jnp.float32),
         "var": jnp.asarray(var, jnp.float32)}, jx, train=train)
    to, tns, _ = _port(layer).forward(
        {"gamma_w": torch.tensor(gamma).bfloat16(),
         "beta": torch.tensor(beta).bfloat16()},
        {"mean": torch.tensor(mean).float(), "var": torch.tensor(var).float()},
        torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16(),
        train=train)
    assert str(to.dtype).split(".")[-1] == str(jo.dtype)
    ref = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(ref).max())
    for k in jns:
        np.testing.assert_allclose(tns[k].float().numpy(),
                                   np.asarray(jns[k].astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-3)


def test_dense_output_and_embedding_match_jax():
    rng = np.random.RandomState(7)
    it = InputType.feed_forward(5)
    _compare(DenseLayer(n_in=5, n_out=3, activation=Activation.SIGMOID),
             rng.randn(4, 5), it)
    _compare(DenseLayer(n_in=5, n_out=3, has_bias=False), rng.randn(4, 5),
             it)
    out = OutputLayer(n_in=5, n_out=3)
    p = _params(out, it, 8)
    x, y = rng.randn(4, 5), np.eye(3)[rng.randint(0, 3, 4)]
    js = out.compute_score({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(y))
    jpe = out.compute_score_per_example(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(y))
    tout = _port(out)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    assert abs(float(tout.compute_score(tp, torch.from_numpy(x),
                                        torch.from_numpy(y))) - float(js)) \
        < TOL
    np.testing.assert_allclose(tout.compute_score_per_example(
        tp, torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jpe), rtol=0, atol=TOL)
    emb = EmbeddingLayer(n_in=7, n_out=3)
    pe = _params(emb, InputType.feed_forward(7), 9)
    idx = rng.randint(0, 7, (5, 1)).astype(np.float64)
    jo, _, _ = emb.forward({k: jnp.asarray(v) for k, v in pe.items()}, {},
                           jnp.asarray(idx), train=False)
    to, _, _ = _port(emb).forward({k: torch.from_numpy(v)
                                   for k, v in pe.items()}, {},
                                  torch.from_numpy(idx))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)


PREPROCESSORS = [
    (jpp.CnnToFeedForwardPreProcessor(3, 4, 2), (5, 2, 3, 4),
     InputType.convolutional(3, 4, 2)),
    (jpp.FeedForwardToCnnPreProcessor(3, 4, 2), (5, 24),
     InputType.feed_forward(24)),
    (jpp.TensorFlowCnnToFeedForwardPreProcessor(3, 4, 2), (5, 2, 3, 4),
     InputType.convolutional(3, 4, 2)),
    (jpp.RnnToFeedForwardPreProcessor(), (5, 3, 4), InputType.recurrent(3)),
    (jpp.FeedForwardToRnnPreProcessor(minibatch=5), (20, 3),
     InputType.feed_forward(3)),
    (jpp.CnnToRnnPreProcessor(3, 4, 2), (5, 2, 3, 4),
     InputType.convolutional(3, 4, 2)),
    (jpp.RnnToCnnPreProcessor(2, 3, 2), (5, 12, 4), InputType.recurrent(12)),
    (jpp.ComposableInputPreProcessor(processors=(
        jpp.CnnToFeedForwardPreProcessor(3, 4, 2),
        jpp.FeedForwardToCnnPreProcessor(4, 3, 2))), (5, 2, 3, 4),
     InputType.convolutional(3, 4, 2)),
]


@pytest.mark.parametrize("pp,shape,it", PREPROCESSORS,
                         ids=lambda v: type(v).__name__ if hasattr(
                             v, "preprocess") else "")
def test_preprocessor_matches_jax(pp, shape, it):
    tp = tpp.InputPreProcessor.from_dict(pp.to_dict())
    assert type(tp).__name__ == type(pp).__name__
    assert tp.to_dict() == pp.to_dict()
    x = np.random.RandomState(10).randn(*shape)
    np.testing.assert_array_equal(tp.preprocess(torch.from_numpy(x)).numpy(),
                                  np.asarray(pp.preprocess(jnp.asarray(x))))
    assert tp.get_output_type(TorchInputType(**it.to_dict())).to_dict() \
        == pp.get_output_type(it).to_dict()
    mask = np.ones((5, 4))
    jm, tm = pp.feed_forward_mask(jnp.asarray(mask)), tp.feed_forward_mask(
        torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(tm), np.asarray(jm))


@pytest.mark.parametrize("model,shape", [
    (LeNet, (1, 1, 1)), (LeNet, (1, 4, 4)), (SimpleCNN, (3, 1, 1)),
    (SimpleCNN, (3, 16, 16))],
    ids=["LeNet-1x1", "LeNet-4x4", "SimpleCNN-1x1", "SimpleCNN-16x16"])
def test_zoo_cnn_multilayer_matches_jax(model, shape):
    """At the smallest input each accepts (every layer is Same mode, so
    1x1) and at one where the pools and convolutions see real windows."""
    jax_model = {LeNet: JaxLeNet, SimpleCNN: JaxSimpleCNN}[model]
    jz = jax_model(num_labels=3, input_shape=shape, dtype="float64")
    tz = model(num_labels=3, input_shape=shape, dtype="float64")
    assert tz.conf().to_json() == jz.conf().to_json()
    jnet = _init_from_port(MultiLayerNetwork(jz.conf()), TorchNet,
                           conf_from_json)
    tnet = TorchNet(conf_from_json(jnet.conf.to_json()), device="cpu").init(
        params_from_jax(jnet.params_tree, device="cpu"))
    rng = np.random.RandomState(3)
    x = rng.randn(2, *shape) if model is SimpleCNN \
        else rng.randn(2, int(np.prod(shape)))
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=1e-9)


def test_batchnorm_multilayer_fit_on_device_matches_jax():
    """A conv -> BN -> ReLU -> pool -> dense head MultiLayerNetwork: two
    fit_on_device steps carry BatchNorm's running statistics from step to
    step, as the JAX package does (losses, params and state, 1e-9)."""
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.common.enums import WeightInit
    from deeplearning4j_tpu.nn.conf.layers.feedforward import ActivationLayer
    from deeplearning4j_tpu.nn.updater.updaters import RmsProp
    conf = (NeuralNetConfiguration.Builder().seed(11)
            .weight_init(WeightInit.XAVIER)
            .updater(RmsProp(learning_rate=0.01)).dtype("float64").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    convolution_mode=ConvolutionMode.Same))
            .layer(BatchNormalization(decay=0.7))
            .layer(ActivationLayer(activation=Activation.RELU))
            .layer(SubsamplingLayer(pooling_type=PoolingType.AVG))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(6, 6, 2)).build())
    jnet = _init_from_port(MultiLayerNetwork(conf), TorchNet, conf_from_json)
    tnet = TorchNet(conf_from_json(jnet.conf.to_json()), device="cpu").init(
        params_from_jax(jnet.params_tree, device="cpu"))
    rng = np.random.RandomState(12)
    x = rng.randn(5, 2, 6, 6) + 1.0
    y = np.eye(3)[rng.randint(0, 3, 5)]
    np.testing.assert_allclose(tnet.fit_on_device(x, y, steps=2),
                               np.asarray(jnet.fit_on_device(x, y, steps=2)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=0, atol=1e-9)
    for ts, js in zip(tnet.state_tree, jnet.state_tree):
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=0, atol=1e-9)
