"""The port's ComputationGraph (configuration, vertices, forward, training
and the fused 1x1-conv + BatchNorm route) against the JAX package's, on
the CPU.

- The mini bottleneck graph: ResNet50's own `_conv_block` and
  `_identity_block` at filters (4, 4, 8), input 8x8x4, batch 6, a global
  average pool and an NLL softmax head, RmsProp, l1 and l2. In float64,
  `output`, `gradient_and_score`, three `fit_on_device` steps (losses,
  parameters, running statistics) agree within 1e-9 with the JAX package
  with its helpers on (its fused Pallas route) and off (its unfused
  route); the port always fuses in training. (The same graph in bf16
  is in tests/test_torch_conv_fused.py.)
- Configuration: graph JSON both ways, the topological order, the flat
  parameter order, every vertex; `_conv_bn_fusable` on ResNet50 (36 pairs)
  and on the JAX package's guard graph; ResNet50's node count, parameter
  count and layer order. (LeNet and SimpleCNN, MultiLayerNetworks, are in
  tests/test_torch_cnn_layers.py.)
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.common.enums import (Activation, ConvolutionMode,
                                             LossFunction, PoolingType,
                                             WeightInit)
from deeplearning4j_tpu.models.resnet50 import ResNet50 as JaxResNet50
from deeplearning4j_tpu.nn.conf.input_type import InputType
from deeplearning4j_tpu.nn.conf.layers.convolutional import (
    ConvolutionLayer, GlobalPoolingLayer)
from deeplearning4j_tpu.nn.conf.layers.feedforward import OutputLayer
from deeplearning4j_tpu.nn.conf.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu.nn.graph import vertices as jv
from deeplearning4j_tpu.nn.graph.computation_graph import ComputationGraph
from deeplearning4j_tpu.nn.updater.updaters import Adam, RmsProp
from deeplearning4j_tpu.ops.helpers import enable_helpers
from deeplearning4j_tpu_torch import ComputationGraph as TorchGraph
from deeplearning4j_tpu_torch.convert import (graph_conf_from_json,
                                              opt_state_from_jax,
                                              params_from_jax,
                                              states_from_jax)
from deeplearning4j_tpu_torch.models import ResNet50
from deeplearning4j_tpu_torch.nn.graph import vertices as tv

TOL = 1e-9


def _mini(dtype="float64", compute_dtype=None):
    z = JaxResNet50(num_labels=3, seed=7)
    g = (NeuralNetConfiguration.Builder().seed(7)
         .activation(Activation.IDENTITY)
         .updater(RmsProp(learning_rate=0.01, rms_decay=0.96))
         .weight_init(WeightInit.XAVIER).l1(1e-4).l2(5e-4)
         .convolution_mode(ConvolutionMode.Truncate).dtype(dtype)
         .compute_dtype(compute_dtype).graph_builder())
    g.add_inputs("input")
    x = z._conv_block(g, (3, 3), (4, 4, 8), "2", "a", "input")
    x = z._identity_block(g, (3, 3), (4, 4, 8), "2", "b", x)
    (g.add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), x)
      .add_layer("output", OutputLayer(
          n_out=3, loss_fn=LossFunction.NEGATIVELOGLIKELIHOOD,
          activation=Activation.SOFTMAX), "pool")
      .set_outputs("output")
      .set_input_types(InputType.convolutional(8, 8, 4)))
    return _init_from_port(ComputationGraph(g.build()), TorchGraph,
                           graph_conf_from_json)


def _init_from_port(jnet, port_cls, from_json):
    """`jnet` initialized with the port's draws (one torch init, fast on
    the CPU, instead of the JAX package's op-by-op draws)."""
    tnet = port_cls(from_json(jnet.conf.to_json()), device="cpu").init()
    return jnet.init(params=[{k: v.numpy() for k, v in p.items()}
                             for p in tnet.params_tree])


def _port(jnet):
    return TorchGraph(graph_conf_from_json(jnet.conf.to_json()),
                      device="cpu").init(
        params_from_jax(jnet.params_tree, device="cpu"))


def _jax_gradient_and_score(jnet, x, y):
    """The JAX graph's gradient_and_score (value_and_grad of its _loss_fn),
    jitted: one compile instead of op-by-op dispatch of its Pallas
    kernel in interpret mode."""
    from deeplearning4j_tpu.util.flat_params import flatten_params

    @jax.jit
    def vg(params, states, x, y):
        (loss, _), grads = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
            params, states, (x,), (y,), None, None, None, True, None)
        return flatten_params(grads), loss
    g, loss = vg(jnet.params_tree, jnet.state_tree, jnp.asarray(x),
                 jnp.asarray(y))
    return np.asarray(g), float(loss)


def _batch(dtype=np.float64):
    rng = np.random.RandomState(0)
    return (rng.randn(6, 4, 8, 8).astype(dtype),
            np.eye(3)[rng.randint(0, 3, 6)].astype(dtype))


def _states(states):
    return np.concatenate([np.asarray(v, np.float64).ravel() for s in states
                           for _, v in sorted(s.items())])


@pytest.fixture(params=[True, False], ids=["helpers_on", "helpers_off"])
def helpers(request):
    enable_helpers(request.param)
    yield request.param
    enable_helpers(False)


def test_mini_bottleneck_matches_jax_fp64(helpers):
    x, y = _batch()
    jnet = _mini()
    tnet = _port(jnet)
    assert tnet._conv_bn_fusable() == jnet._conv_bn_fusable()
    assert len(tnet._conv_bn_fusable()) == 5
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=TOL)
    jg, jl = _jax_gradient_and_score(jnet, x, y)
    tg, tl = tnet.gradient_and_score(x, y)
    assert abs(tl - jl) < TOL
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=TOL)
    jls = np.asarray(jnet.fit_on_device(x, y, steps=3))
    tls = tnet.fit_on_device(x, y, steps=3)
    np.testing.assert_allclose(tls, jls, rtol=0, atol=TOL)
    np.testing.assert_allclose(tnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=0, atol=TOL)
    np.testing.assert_allclose(_states(tnet.state_tree),
                               _states(jnet.state_tree), rtol=0, atol=TOL)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=TOL)


def test_mini_bottleneck_fit_paths_match_jax_fp64():
    """fit(x, y), fit(DataSet), fit_batch, score and score_examples, after
    the updater state and running statistics are carried over."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    x, y = _batch()
    jnet = _mini()
    jnet.fit_batch(x, y)
    tnet = _port(jnet)
    tnet._opt_state = opt_state_from_jax(jnet._opt_state, device="cpu")
    tnet.state_tree = states_from_jax(jnet.state_tree, device="cpu")
    tnet._step = jnet._step
    jnet.fit(x, y)
    tnet.fit(x, y)
    jnet.fit(JaxDataSet(x, y))
    tnet.fit(DataSet(x, y))
    jnet.fit([JaxDataSet(x, y)])
    tnet.fit([DataSet(x, y)])
    np.testing.assert_allclose(tnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=0, atol=TOL)
    np.testing.assert_allclose(tnet.get_updater_state_view().numpy(),
                               np.asarray(jnet.get_updater_state_view()),
                               rtol=0, atol=TOL)
    # jnet.score(ds), jitted (one compile instead of op-by-op dispatch)
    j_score = float(jax.jit(lambda p, st: jnet._loss_fn(
        p, st, (jnp.asarray(x),), (jnp.asarray(y),), None, None, None, False,
        None)[0])(jnet.params_tree, jnet.state_tree))
    assert abs(tnet.score(DataSet(x, y)) - j_score) < TOL
    # jnet.score_examples(ds, True), jitted: the head's per-example loss
    # on the inference forward, plus the regularization

    @jax.jit
    def j_per_example(p, st):
        values, _, _ = jnet._forward_all(p, st, [jnp.asarray(x)],
                                         train=False)
        out = jnet.conf.nodes["output"]
        reg = sum(layer.regularization_score(q)
                  for layer, q in zip(jnet.layers, p))
        return out.conf.compute_score_per_example(
            p[jnet.layer_names.index("output")], values["pool"],
            jnp.asarray(y)) + reg
    np.testing.assert_allclose(
        tnet.score_examples(DataSet(x, y), True).numpy(),
        np.asarray(j_per_example(jnet.params_tree, jnet.state_tree)),
        rtol=0, atol=TOL)
    clone = tnet.clone()
    np.testing.assert_array_equal(clone.params().numpy(),
                                  tnet.params().numpy())


def test_graph_json_topological_order_and_flat_order():
    jnet = _mini()
    conf = graph_conf_from_json(jnet.conf.to_json())
    assert conf.to_json() == jnet.conf.to_json()
    assert list(conf.nodes) == list(jnet.conf.nodes)
    assert conf.topo_order == jnet.conf.topo_order
    tnet = TorchGraph(conf, device="cpu")
    assert tnet.layer_names == jnet.layer_names
    tnet.init(params_from_jax(jnet.params_tree, device="cpu"))
    np.testing.assert_array_equal(tnet.params().numpy(),
                                  np.asarray(jnet.params()))
    assert tnet.num_params() == jnet.num_params()
    assert {n: [t.to_dict() for t in ts] for n, ts in
            conf.node_input_types().items()} == \
        {n: [t.to_dict() for t in ts] for n, ts in
         jnet.conf.node_input_types().items()}
    flat = np.random.RandomState(1).randn(jnet.num_params())
    tnet.set_params(flat)
    np.testing.assert_array_equal(tnet.params().numpy(), flat)


VERTICES = [
    (jv.MergeVertex(), [(2, 3, 4), (2, 5, 4)]),
    (jv.ElementWiseVertex(op="Add"), [(2, 3), (2, 3), (2, 3)]),
    (jv.ElementWiseVertex(op="Subtract"), [(2, 3), (2, 3)]),
    (jv.ElementWiseVertex(op="Product"), [(2, 3), (2, 3)]),
    (jv.ElementWiseVertex(op="Average"), [(2, 3), (2, 3)]),
    (jv.ElementWiseVertex(op="Max"), [(2, 3), (2, 3)]),
    (jv.SubsetVertex(from_idx=1, to_idx=2), [(2, 4, 5)]),
    (jv.StackVertex(), [(2, 3, 5), (2, 3, 5)]),
    (jv.UnstackVertex(from_idx=1, stack_size=2), [(4, 3, 5)]),
    (jv.ScaleVertex(scale_factor=1.5), [(2, 3)]),
    (jv.ShiftVertex(shift_factor=-0.5), [(2, 3)]),
    (jv.ReshapeVertex(new_shape=(2, 3, 2, 2)), [(2, 12)]),
    (jv.L2Vertex(), [(2, 3, 2), (2, 3, 2)]),
    (jv.L2NormalizeVertex(), [(2, 3, 2, 2)]),
    (jv.PoolHelperVertex(), [(2, 3, 4, 4)]),
    (jv.LastTimeStepVertex(), [(3, 2, 5)]),
    (jv.DuplicateToTimeSeriesVertex(), [(2, 3), (2, 4, 6)]),
]


@pytest.mark.parametrize("vertex,shapes", VERTICES,
                         ids=[f"{type(v).__name__}-{i}"
                              for i, (v, _) in enumerate(VERTICES)])
def test_vertex_matches_jax(vertex, shapes):
    tvx = tv.GraphVertex.from_dict(vertex.to_dict())
    assert tvx.to_dict() == vertex.to_dict()
    rng = np.random.RandomState(2)
    xs = [rng.randn(*s) for s in shapes]
    masks = [None] * len(xs)
    if len(shapes[0]) == 3:                   # an RNN input carries a mask
        m = np.ones((shapes[0][0], shapes[0][2]))
        m[0, -2:] = 0.0
        masks[0] = m
    jo, jm = vertex.forward([jnp.asarray(a) for a in xs],
                            [None if m is None else jnp.asarray(m)
                             for m in masks])
    to, tm = tvx.forward([torch.from_numpy(a) for a in xs],
                         [None if m is None else torch.from_numpy(m)
                          for m in masks])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-12)
    assert (tm is None) == (jm is None)
    if tm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_resnet50_configuration_matches_jax():
    jconf = JaxResNet50().conf()
    tnet = TorchGraph(ResNet50().conf(), device="cpu")
    assert len(tnet.conf.nodes) == 175
    assert tnet.conf.to_json() == jconf.to_json()
    jnet = ComputationGraph(jconf)
    assert tnet.layer_names == jnet.layer_names
    pairs = tnet._conv_bn_fusable()
    assert len(pairs) == 36 and pairs == jnet._conv_bn_fusable()
    # JAX's parameter count from the shapes alone (no 25M-parameter draw)
    jax_count = 0
    in_types = jconf.node_input_types()
    for name in jnet.layer_names:
        layer = jconf.nodes[name].conf
        if layer.has_params():
            shapes = jax.eval_shape(
                lambda k, _l=layer, _t=in_types[name][0]: _l.init_params(
                    k, _t, jnp.float32), jax.random.PRNGKey(0))
            jax_count += sum(int(np.prod(s.shape))
                             for s in jax.tree_util.tree_leaves(shapes))
    tnet.init()
    assert tnet.num_params() == jax_count


def test_fusable_guard_graph_matches_jax():
    """The JAX package's guard graph: a conv with a second consumer, and
    one with its own activation, do not fuse."""
    from deeplearning4j_tpu.nn.graph.vertices import ElementWiseVertex
    g = (NeuralNetConfiguration.Builder().seed(3).dtype("float64")
         .activation(Activation.IDENTITY).weight_init(WeightInit.XAVIER)
         .updater(Adam(learning_rate=1e-2)).graph_builder())
    (g.add_inputs("in")
      .add_layer("c1", ConvolutionLayer(n_out=4, kernel_size=(1, 1)), "in")
      .add_layer("b1", BatchNormalization(), "c1")
      .add_vertex("both", ElementWiseVertex(op="Add"), "b1", "c1")
      .add_layer("c2", ConvolutionLayer(n_out=4, kernel_size=(1, 1),
                                        activation=Activation.RELU), "both")
      .add_layer("b2", BatchNormalization(), "c2")
      .add_layer("c3", ConvolutionLayer(n_out=4, kernel_size=(1, 1)), "b2")
      .add_layer("b3", BatchNormalization(lock_gamma_beta=True), "c3")
      .add_layer("c4", ConvolutionLayer(n_out=4, kernel_size=(1, 1)), "b3")
      .add_layer("b4", BatchNormalization(activation=Activation.RELU), "c4")
      .add_layer("out", OutputLayer(n_out=2, loss_fn=LossFunction.MCXENT,
                                    activation=Activation.SOFTMAX), "b4")
      .set_outputs("out")
      .set_input_types(InputType.convolutional(2, 2, 4)))
    jnet = ComputationGraph(g.build())
    tnet = TorchGraph(graph_conf_from_json(jnet.conf.to_json()),
                      device="cpu")
    assert tnet._conv_bn_fusable() == jnet._conv_bn_fusable() \
        == {"c4": "b4"}


def test_graph_methods_not_ported_raise():
    tnet = _port(_mini())
    x, y = _batch()
    for call in (lambda: tnet.fit_tbptt(x, y), lambda: tnet.rnn_time_step(x),
                 lambda: tnet.evaluate([]),
                 lambda: tnet.configure_health(),
                 lambda: tnet.fit_batch(x, y, rnn_init_states=[None])):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()
