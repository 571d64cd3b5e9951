"""The port's layers, configuration and MultiLayerNetwork against the JAX
package, in float64 on the CPU.

Inputs are numpy draws; the JAX parameters are carried over with
`params_from_jax` and the configuration with `conf_from_json`, so both
packages compute on identical numbers. Tolerance 1e-10.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import (Activation, InputType, MultiLayerNetwork,
                                NeuralNetConfiguration, RnnOutputLayer, Sgd,
                                WeightInit)
from deeplearning4j_tpu.nn.conf.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu.nn.conf.layers.feedforward import ActivationLayer
from deeplearning4j_tpu_torch import MultiLayerNetwork as TorchNet
from deeplearning4j_tpu_torch import NeuralNetConfiguration as TorchNNC
from deeplearning4j_tpu_torch import InputType as TorchInputType
from deeplearning4j_tpu_torch import RnnOutputLayer as TorchRnnOut
from deeplearning4j_tpu_torch import SelfAttentionLayer as TorchAttn
from deeplearning4j_tpu_torch.convert import conf_from_json, params_from_jax
from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf

ATOL = 1e-10
V = 13


def _jax_net(n_kv=2, window=0, n_layers=2, act_layer=False, seed=5):
    b = (NeuralNetConfiguration.Builder().seed(seed)
         .weight_init(WeightInit.XAVIER)
         .updater(Sgd(learning_rate=0.05)).dtype("float64").list())
    for i in range(n_layers):
        b.layer(SelfAttentionLayer(n_out=8, n_heads=4, n_kv_heads=n_kv,
                                   causal=True, block_size=0,
                                   attention_window=window))
        if act_layer and i == 0:
            b.layer(ActivationLayer(activation=Activation.TANH))
    b.layer(RnnOutputLayer(n_out=V, activation=Activation.SOFTMAX))
    return MultiLayerNetwork(
        b.set_input_type(InputType.recurrent(V)).build()).init()


def _port(net):
    return TorchNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))


ATTN = [dict(causal=True, n_kv_heads=2), dict(causal=True, n_kv_heads=1),
        dict(causal=True, n_kv_heads=0, attention_window=3),
        dict(causal=False, n_kv_heads=2, attention_window=2),
        dict(causal=True, n_kv_heads=2, masked=True)]


@pytest.mark.parametrize("kw", ATTN, ids=lambda d: "-".join(
    f"{k}{v}" for k, v in d.items()))
def test_self_attention_forward_parity(kw):
    kw = dict(kw)
    masked = kw.pop("masked", False)
    layer = SelfAttentionLayer(n_in=6, n_out=8, n_heads=4, block_size=0,
                               activation=Activation.TANH, **kw)
    params = layer.init_params(jax.random.PRNGKey(1), None, jnp.float64)
    tlayer = BaseLayerConf.from_dict(json.loads(json.dumps(layer.to_dict())))
    assert isinstance(tlayer, TorchAttn)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 7)
    mask = (rng.rand(2, 7) > 0.3).astype(np.float64) if masked else None
    ref, _, _ = layer.forward(params, {}, jnp.asarray(x), train=False,
                              mask=None if mask is None
                              else jnp.asarray(mask))
    tp = params_from_jax([params], device="cpu")[0]
    out, _, _ = tlayer.forward(tp, {}, torch.from_numpy(x),
                               mask=None if mask is None
                               else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_rnn_output_layer_forward_parity():
    layer = RnnOutputLayer(n_in=8, n_out=V, activation=Activation.SOFTMAX)
    params = layer.init_params(jax.random.PRNGKey(3), None, jnp.float64)
    tlayer = BaseLayerConf.from_dict(layer.to_dict())
    assert isinstance(tlayer, TorchRnnOut)
    x = np.random.RandomState(4).randn(3, 8, 5)
    mask = (np.random.RandomState(5).rand(3, 5) > 0.2).astype(np.float64)
    ref, _, _ = layer.forward(params, {}, jnp.asarray(x), train=False,
                              mask=jnp.asarray(mask))
    out, _, _ = tlayer.forward(params_from_jax([params], device="cpu")[0],
                               {}, torch.from_numpy(x),
                               mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("n_kv,window,act_layer", [(2, 0, False),
                                                   (0, 3, True)])
def test_network_output_and_feed_forward_parity(n_kv, window, act_layer):
    net = _jax_net(n_kv=n_kv, window=window, act_layer=act_layer)
    tnet = _port(net)
    x = np.random.RandomState(6).randn(2, V, 9)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(net.output(x)), atol=ATOL, rtol=0)
    acts = tnet.feed_forward(x)
    ref = net.feed_forward(x)
    assert len(acts) == len(ref)
    for a, r in zip(acts, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


def test_jax_json_builds_the_same_stack_both_ways():
    """A JAX configuration JSON builds the same stack in the port, and the
    port's JSON builds it back in the JAX package."""
    from deeplearning4j_tpu.nn.conf.configuration import \
        MultiLayerConfiguration as JaxConf
    net = _jax_net(n_kv=2, window=3, act_layer=True)
    jd = json.loads(net.conf.to_json())
    tconf = conf_from_json(net.conf.to_json())
    assert [type(l).__name__ for l in tconf.layers] == \
        [type(l).__name__ for l in net.conf.layers]
    td = json.loads(tconf.to_json())
    assert td["layers"] == jd["layers"]
    assert td["global_conf"] == jd["global_conf"]
    assert td["input_type"] == jd["input_type"]
    back = JaxConf.from_json(tconf.to_json())
    assert [l.to_dict() for l in back.layers] == jd["layers"]


def test_port_builder_infers_widths_like_jax():
    tconf = (TorchNNC.Builder().seed(1).weight_init("xavier").list()
             .layer(TorchAttn(n_out=8, n_heads=4, n_kv_heads=2, causal=True,
                              block_size=0))
             .layer(TorchRnnOut(n_out=V))
             .set_input_type(TorchInputType.recurrent(V)).build())
    jnet = _jax_net(n_kv=2, n_layers=1)
    assert [l.to_dict() for l in tconf.layers] == \
        [l.to_dict() for l in jnet.conf.layers]


def test_xavier_init_shapes_and_scale():
    """Port-side init draws XAVIER from an explicit generator: the JAX
    shapes, std sqrt(2 / (fan_in + fan_out)), and the same draw for the
    same seed."""
    net = _jax_net(n_kv=2)
    conf = conf_from_json(net.conf.to_json())
    a = TorchNet(conf, device="cpu").init(
        generator=torch.Generator().manual_seed(7))
    b = TorchNet(conf, device="cpu").init(
        generator=torch.Generator().manual_seed(7))
    for pj, pa, pb in zip(net.params_tree, a.params_tree, b.params_tree):
        assert {k: tuple(v.shape) for k, v in pj.items()} == \
            {k: tuple(v.shape) for k, v in pa.items()}
        for k in pa:
            assert torch.equal(pa[k], pb[k])
            assert pa[k].dtype == torch.float64
    big = TorchAttn(n_in=256, n_out=256, n_heads=4, causal=True)
    p = big.init_params(torch.Generator().manual_seed(0), None,
                        torch.float64)
    assert abs(p["w_q"].std().item() - np.sqrt(2 / 512)) < 0.003


def test_long_context_branch_raises():
    layer = TorchAttn(n_in=4, n_out=8, n_heads=4, causal=True, block_size=4)
    p = layer.init_params(torch.Generator().manual_seed(0), None)
    with pytest.raises(NotImplementedError, match="K3"):
        layer.forward(p, {}, torch.zeros(1, 4, 5))
    layer.forward(p, {}, torch.zeros(1, 4, 4))        # T <= block_size: dense


def test_unported_layer_and_preprocessor_raise():
    from deeplearning4j_tpu.nn.conf.layers.feedforward import DenseLayer
    with pytest.raises(NotImplementedError, match="DenseLayer"):
        BaseLayerConf.from_dict(DenseLayer(n_in=2, n_out=3).to_dict())
    d = json.loads(_jax_net().conf.to_json())
    d["preprocessors"] = {"0": {"@class": "RnnToFeedForwardPreProcessor"}}
    with pytest.raises(NotImplementedError, match="preprocessor"):
        conf_from_json(json.dumps(d))
