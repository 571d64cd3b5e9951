"""Training in the port (deeplearning4j_tpu_torch.MultiLayerNetwork.fit and
friends) against the JAX package, in float64 on the CPU.

Both networks are built from one configuration JSON; the JAX parameters
(and, where a test resumes training, the updater state) are carried into
the port, and inputs are numpy draws, so both packages step on identical
numbers. The long-context stack (SelfAttentionLayer with block_size 4 at
T = 12) runs the flash-attention path in both: the port's plain versions
of K3-K5, the JAX package's Pallas kernels in interpret mode under
helpers_enabled_ctx(True) and its lax.scan blockwise recurrence under the
default. Tolerance 1e-9 unless a test states otherwise.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deeplearning4j_tpu.ops.flash_attention  # noqa: F401  (registers it)
from deeplearning4j_tpu import (Activation, InputType, MultiLayerNetwork,
                                NeuralNetConfiguration, RnnOutputLayer,
                                WeightInit)
from deeplearning4j_tpu.common.enums import (GradientNormalization,
                                             LossFunction)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn.conf.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu.nn.conf.layers.feedforward import (DropoutLayer,
                                                           LossLayer)
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu.ops.helpers import helpers_enabled_ctx
from deeplearning4j_tpu.util.flat_params import flatten_params
from deeplearning4j_tpu_torch import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.convert import (conf_from_json,
                                              opt_state_from_jax,
                                              params_from_jax)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import losses as tlosses
from deeplearning4j_tpu_torch.nn.conf.layers.base import apply_dropout
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.util.flat_params import tree_leaves

TOL = 1e-9
V, T, B = 5, 12, 2


def _conf(updater, n_kv=2, window=0, block_size=4, layer_kw=None,
          dtype="float64", compute_dtype=None, remat=False, dropout_layer=0.0):
    b = (NeuralNetConfiguration.Builder().seed(3)
         .weight_init(WeightInit.XAVIER).updater(updater).dtype(dtype))
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    if remat:
        b.remat(True)
    b = b.list()
    for _ in range(2):
        b.layer(SelfAttentionLayer(n_out=8, n_heads=4, n_kv_heads=n_kv,
                                   causal=True, block_size=block_size,
                                   attention_window=window,
                                   **(layer_kw or {})))
    if dropout_layer:
        b.layer(DropoutLayer(dropout=dropout_layer))
    b.layer(RnnOutputLayer(n_out=V, activation=Activation.SOFTMAX))
    return b.set_input_type(InputType.recurrent(V)).build()


def _pair(updater, **kw):
    net = MultiLayerNetwork(_conf(updater, **kw)).init()
    tnet = TNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))
    return net, tnet


def _data(seed=0, masked=False, steps=None):
    rng = np.random.RandomState(seed)
    lead = (steps,) if steps else ()
    x = rng.randn(*lead, B, V, T)
    y = np.eye(V)[rng.randint(0, V, lead + (B, T))]
    y = np.moveaxis(y, -1, -2)
    m = None
    if masked:
        m = (rng.rand(*lead, B, T) > 0.25).astype(np.float64)
        m[..., 0] = 1.0
    return x, y, m


def _assert_params(net, tnet, tol=TOL):
    np.testing.assert_allclose(tnet.params().numpy(), np.asarray(net.params()),
                               atol=tol, rtol=0)


# ------------------------------------------------------------------ updaters
UPDATERS = {
    "Sgd": dict(learning_rate=0.1), "NoOp": {},
    "Nesterovs": dict(learning_rate=0.05, momentum=0.9),
    "Adam": dict(learning_rate=0.01), "AdaMax": dict(learning_rate=0.01),
    "Nadam": dict(learning_rate=0.01), "AdaGrad": dict(learning_rate=0.1),
    "RmsProp": dict(learning_rate=0.01), "AdaDelta": dict(rho=0.9),
}


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_matches_jax_over_three_steps(name):
    rng = np.random.RandomState(1)
    params = {"W": rng.randn(3, 4), "b": rng.randn(4)}
    ju = jupd.UPDATER_REGISTRY[name](**UPDATERS[name])
    tu = tupd.BaseUpdater.from_dict(ju.to_dict())
    assert type(tu).__name__ == name and tu.to_dict() == ju.to_dict()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = ju.init(jp), tu.init(tp)
    for t in range(3):
        g = {k: rng.randn(*v.shape) for k, v in params.items()}
        jup, js = ju.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                            t)
        tup_, ts = tu.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp, t)
        for a, b in zip(tree_leaves(tup_), jax.tree_util.tree_leaves(jup)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12,
                                       rtol=1e-12)
        for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12,
                                       rtol=1e-12)
        jp = {k: jp[k] - jup[k] for k in jp}
        tp = {k: tp[k] - tup_[k] for k in tp}


SCHEDULES = [{"type": "exponential", "decay_rate": 0.9},
             {"type": "step", "decay_rate": 0.5, "steps": 2},
             {"type": "inverse", "gamma": 0.1, "power": 0.75},
             {"type": "poly", "power": 2.0, "max_iter": 5},
             {"type": "sigmoid", "gamma": 0.5, "steps": 1}]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["type"])
def test_schedule_lr_matches_jax(sched):
    for t in range(4):
        assert tupd.schedule_lr(0.1, sched, t) == pytest.approx(
            float(jupd.schedule_lr(0.1, sched, t)), rel=1e-6, abs=0)
    assert tupd.schedule_lr(0.1, None, 3) == 0.1
    ju = jupd.Sgd(learning_rate=0.1, schedule=sched)
    tu = tupd.Sgd(learning_rate=0.1, schedule=sched)
    g = np.random.RandomState(2).randn(5)
    for t in range(3):
        a, _ = tu.update({"W": torch.from_numpy(g)}, {}, None, t)
        b, _ = ju.update({"W": jnp.asarray(g)}, {}, None, t)
        np.testing.assert_allclose(a["W"].numpy(), np.asarray(b["W"]),
                                   rtol=1e-6, atol=0)


def test_updater_from_name_and_builder():
    for name in ("sgd", "adam", "adadelta", "nesterovs", "none"):
        assert tupd.updater_from_name(name, 0.2).to_dict() == \
            jupd.updater_from_name(name, 0.2).to_dict()
    from deeplearning4j_tpu_torch import NeuralNetConfiguration as TNNC
    conf = (TNNC.Builder().learning_rate(0.03).updater("adam").list()
            .build())
    assert isinstance(conf.get_updater(), tupd.Adam)
    assert conf.get_updater().learning_rate == 0.03
    assert isinstance(TNNC.Builder().list().build().get_updater(), tupd.Sgd)


# -------------------------------------------------------------------- losses
LOSS_ACTS = {
    LossFunction.MSE: Activation.IDENTITY, LossFunction.L1: Activation.TANH,
    LossFunction.L2: Activation.IDENTITY,
    LossFunction.MCXENT: Activation.SOFTMAX,
    LossFunction.NEGATIVELOGLIKELIHOOD: Activation.SIGMOID,
    LossFunction.XENT: Activation.SIGMOID,
    LossFunction.SPARSE_MCXENT: Activation.SOFTMAX,
    LossFunction.HINGE: Activation.IDENTITY,
    LossFunction.SQUARED_HINGE: Activation.TANH,
    LossFunction.KL_DIVERGENCE: Activation.SOFTMAX,
    LossFunction.POISSON: Activation.SOFTPLUS,
    LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR: Activation.IDENTITY,
    LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR: Activation.SOFTPLUS,
    LossFunction.COSINE_PROXIMITY: Activation.IDENTITY,
}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("loss", list(LOSS_ACTS), ids=lambda l: l.value)
def test_loss_matches_jax(loss, masked):
    rng = np.random.RandomState(3)
    z = rng.randn(6, 4)
    if loss == LossFunction.SPARSE_MCXENT:
        y = rng.randint(0, 4, (6,)).astype(np.float64)
    elif loss in (LossFunction.HINGE, LossFunction.SQUARED_HINGE):
        y = np.sign(rng.randn(6, 4))
    else:
        y = rng.rand(6, 4)
    m = (rng.rand(6) > 0.4).astype(np.float64) if masked else None
    act = LOSS_ACTS[loss]
    for jf, tf in ((jlosses.compute_loss, tlosses.compute_loss),
                   (jlosses.compute_loss_per_example,
                    tlosses.compute_loss_per_example)):
        ref = jf(loss, jnp.asarray(y), jnp.asarray(z), act,
                 None if m is None else jnp.asarray(m))
        out = tf(loss, torch.from_numpy(y), torch.from_numpy(z), act,
                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12,
                                   rtol=1e-12)


def test_loss_layer_scores_match_jax():
    rng = np.random.RandomState(4)
    x, y = rng.randn(3, 4), rng.rand(3, 4)
    jl = LossLayer(loss_fn=LossFunction.MSE, activation=Activation.TANH)
    from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf
    tl = BaseLayerConf.from_dict(jl.to_dict())
    np.testing.assert_allclose(
        tl.compute_score({}, torch.from_numpy(x), torch.from_numpy(y))
        .numpy(), np.asarray(jl.compute_score({}, jnp.asarray(x),
                                              jnp.asarray(y))), atol=1e-12)
    np.testing.assert_allclose(
        tl.compute_score_per_example({}, torch.from_numpy(x),
                                     torch.from_numpy(y)).numpy(),
        np.asarray(jl.compute_score_per_example({}, jnp.asarray(x),
                                                jnp.asarray(y))), atol=1e-12)


# ---------------------------------------------------- flat views, gradients
def _jax_gradient_and_score(net, x, y, fmask):
    """The JAX network's gradient_and_score (value_and_grad of its
    _loss_fn in training mode, gradients flattened) under one jax.jit:
    called eagerly it compiles each op on its own, ~5x slower."""
    f = jax.jit(jax.value_and_grad(net._loss_fn, has_aux=True),
                static_argnums=(7,))
    (loss, _), grads = f(net.params_tree, net.state_tree,
                         jnp.asarray(x, net.dtype), jnp.asarray(y, net.dtype),
                         fmask, None, None, True, None)
    return flatten_params(grads), float(loss)


def test_params_order_and_gradient_and_score_match_jax():
    net, tnet = _pair(jupd.Sgd(learning_rate=0.1))
    # JAX flattens each layer's dict by sorted key: b, w_k, w_o, w_q, w_v
    assert tnet.num_params() == net.num_params()
    _assert_params(net, tnet, tol=0)
    x, y, m = _data(masked=True)
    jg, js = _jax_gradient_and_score(net, x, y, jnp.asarray(m))
    tg, ts = tnet.gradient_and_score(x, y, m)
    assert ts == pytest.approx(js, abs=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL, rtol=0)
    flat = np.random.RandomState(5).randn(net.num_params())
    net.set_params(jnp.asarray(flat))
    tnet.set_params(flat)
    for pj, pt in zip(net.params_tree, tnet.params_tree):
        assert sorted(pt) == sorted(pj)
        for k in pj:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


# -------------------------------------------------------------- fit parity
FIT_CASES = {
    "sgd": dict(updater=("Sgd", 0.1)),
    "adam": dict(updater=("Adam", 0.01)),
    "sgd-keymask": dict(updater=("Sgd", 0.1), masked=True),
    "adam-keymask-window": dict(updater=("Adam", 0.01), masked=True,
                                window=3),
}


@pytest.mark.parametrize("helpers", [True, None],
                         ids=["jax-pallas-interpret", "jax-default"])
@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_long_context_matches_jax(name, helpers):
    kw = FIT_CASES[name]
    cls, lr = kw["updater"]
    net, tnet = _pair(jupd.UPDATER_REGISTRY[cls](learning_rate=lr),
                      window=kw.get("window", 0))
    x, y, m = _data(masked=kw.get("masked", False))
    jds = JDataSet(x, y, None if m is None else jnp.asarray(m))
    tds = TDataSet(x, y, m)
    with helpers_enabled_ctx(helpers):
        for _ in range(3):
            net.fit(jds)
            tnet.fit(tds)
            assert tnet.score() == pytest.approx(float(net.score()), abs=TOL)
    _assert_params(net, tnet)
    np.testing.assert_allclose(
        tnet.get_updater_state_view().numpy(),
        np.asarray(net.get_updater_state_view()), atol=TOL, rtol=0)


def test_fit_on_device_equals_fit_batch_and_jax():
    net, tnet = _pair(jupd.Adam(learning_rate=0.01))
    other = tnet.clone()
    x, y, _ = _data(seed=6)
    losses = tnet.fit_on_device(x, y, steps=3)
    ref = [other.fit_batch(x, y) or other.score() for _ in range(3)]
    np.testing.assert_allclose(losses, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(tnet.params().numpy(), other.params().numpy(),
                               atol=TOL, rtol=0)
    jl = net.fit_on_device(x, y, steps=3)
    np.testing.assert_allclose(losses, np.asarray(jl), atol=TOL, rtol=0)
    _assert_params(net, tnet)
    # deferred readback: a device tensor, score and sentinel read later
    dl = tnet.fit_on_device(x, y, steps=2, sync=False)
    assert isinstance(dl, torch.Tensor) and dl.shape == (2,)
    assert tnet._diverged_at is None and tnet._step == 5


def test_fit_on_device_per_step_data_and_vary_batch_match_jax():
    net, tnet = _pair(jupd.Sgd(learning_rate=0.1))
    x, y, m = _data(seed=7, masked=True, steps=3)
    jl = net.fit_on_device(x, y, fmask=jnp.asarray(m))
    tl = tnet.fit_on_device(x, y, fmask=m)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL, rtol=0)
    x1, y1, _ = _data(seed=8)
    jl = net.fit_on_device(x1, y1, steps=2, vary_batch=True)
    tl = tnet.fit_on_device(x1, y1, steps=2, vary_batch=True)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL, rtol=0)
    _assert_params(net, tnet)
    with pytest.raises(ValueError, match="vary_batch"):
        tnet.fit_on_device(x, y, vary_batch=True)


def test_divergence_sentinel_freezes_after_injected_nan():
    _, tnet = _pair(jupd.Sgd(learning_rate=0.1))
    x, y, _ = _data(seed=9, steps=4)
    x[2, 0, 0, 0] = np.nan                 # step 2's batch
    ref = tnet.clone()
    ref.fit_on_device(x[:2], y[:2])
    with pytest.warns(UserWarning, match="step 2"):
        losses = tnet.fit_on_device(x, y)
    assert np.isfinite(losses[:2]).all() and not np.isfinite(losses[2])
    assert tnet._diverged_at == 2
    np.testing.assert_array_equal(tnet.params().numpy(),
                                  ref.params().numpy())
    # deferred: stashed on the device, resolved on first access
    _, t2 = _pair(jupd.Sgd(learning_rate=0.1))
    t2.fit_on_device(x, y, sync=False)
    t2.fit_on_device(x[:1], y[:1], sync=False)    # clean call: sticky
    with pytest.warns(UserWarning):
        assert t2._diverged_at == 2


def test_fit_iterable_with_listeners_matches_jax():
    class Rec:
        def __init__(self):
            self.seen = []

        def iteration_done(self, model, iteration):
            self.seen.append((iteration, float(model.score())))

    net, tnet = _pair(jupd.Sgd(learning_rate=0.1))
    batches = [_data(seed=s) for s in (10, 11, 12)]
    odd = _data(seed=13)
    odd = (odd[0][:1], odd[1][:1], None)            # other shape: a flush
    jr, tr = Rec(), Rec()
    net.set_listeners(jr)
    tnet.set_listeners(tr)
    net.fit([JDataSet(x, y) for x, y, _ in batches + [odd]], epochs=2)
    tnet.fit([TDataSet(x, y) for x, y, _ in batches + [odd]], epochs=2)
    assert [i for i, _ in tr.seen] == [i for i, _ in jr.seen]
    np.testing.assert_allclose([s for _, s in tr.seen],
                               [s for _, s in jr.seen], atol=TOL, rtol=0)
    _assert_params(net, tnet)
    net.fit(batches[0][0], batches[0][1])
    tnet.fit(batches[0][0], batches[0][1])
    _assert_params(net, tnet)


def test_score_and_score_examples_with_l1_l2_match_jax():
    net, tnet = _pair(jupd.Sgd(learning_rate=0.1),
                      layer_kw=dict(l1=0.01, l2=0.02, l2_bias=0.03))
    x, y, m = _data(seed=14, masked=True)
    for _ in range(2):
        net.fit_batch(x, y, jnp.asarray(m))
        tnet.fit_batch(x, y, m)
    _assert_params(net, tnet)
    jds, tds = JDataSet(x, y, jnp.asarray(m)), TDataSet(x, y, m)
    assert tnet.score(tds) == pytest.approx(net.score(jds), abs=TOL)
    for reg in (False, True):
        np.testing.assert_allclose(
            tnet.score_examples(tds, add_regularization=reg).numpy(),
            np.asarray(net.score_examples(jds, add_regularization=reg)),
            atol=TOL, rtol=0)


@pytest.mark.parametrize("gn", [g for g in GradientNormalization
                                if g != GradientNormalization.NoNormalization],
                         ids=lambda g: g.value)
def test_gradient_normalization_matches_jax(gn):
    net, tnet = _pair(jupd.Sgd(learning_rate=0.1),
                      layer_kw=dict(gradient_normalization=gn,
                                    gradient_normalization_threshold=0.05))
    x, y, _ = _data(seed=15)
    for _ in range(2):
        net.fit_batch(x, y)
        tnet.fit_batch(x, y)
    _assert_params(net, tnet)


def test_remat_equals_no_remat():
    _, plain = _pair(jupd.Adam(learning_rate=0.01))
    _, remat = _pair(jupd.Adam(learning_rate=0.01), remat=True)
    assert remat.conf.global_conf.remat
    x, y, m = _data(seed=16, masked=True)
    for _ in range(2):
        plain.fit_batch(x, y, m)
        remat.fit_batch(x, y, m)
    np.testing.assert_allclose(remat.params().numpy(), plain.params().numpy(),
                               atol=1e-12, rtol=0)


def test_opt_state_from_jax_resumes_training():
    net, _ = _pair(jupd.Adam(learning_rate=0.01))
    x, y, _ = _data(seed=17)
    for _ in range(2):
        net.fit_batch(x, y)
    tnet = TNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))
    tnet._opt_state = opt_state_from_jax(net._opt_state, device="cpu")
    tnet._step = net._step
    np.testing.assert_array_equal(tnet.get_updater_state_view().numpy(),
                                  np.asarray(net.get_updater_state_view()))
    for _ in range(2):
        net.fit_batch(x, y)
        tnet.fit_batch(x, y)
    _assert_params(net, tnet)


def test_bf16_compute_dtype_within_bf16_tolerance():
    """float32 storage with bfloat16 compute in both packages: the losses
    agree within 2e-2 and the params after two steps within 5e-3 (bf16
    keeps 8 bits of mantissa, and the two packages round the attention
    inputs and outputs at different places)."""
    net, tnet = _pair(jupd.Sgd(learning_rate=0.1), dtype="float32",
                      compute_dtype="bfloat16")
    assert tnet.compute_dtype == torch.bfloat16
    x, y, _ = _data(seed=18)
    for _ in range(2):
        net.fit_batch(x, y)
        tnet.fit_batch(x, y)
        assert tnet.score() == pytest.approx(float(net.score()), abs=2e-2)
    assert tnet.params().dtype == torch.float32
    np.testing.assert_allclose(tnet.params().numpy(), np.asarray(net.params()),
                               atol=5e-3, rtol=0)


def test_dropout_statistics_and_determinism():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500, dtype=torch.float64)
    out = apply_dropout(x, 0.8, g)
    kept = (out != 0).double().mean().item()
    assert abs(kept - 0.8) < 0.005
    assert torch.all((out == 0) | (out == 1.0 / 0.8))
    assert abs(out.mean().item() - 1.0) < 0.01
    # a dropout layer in the stack: training draws from the network's
    # generator (seed + 1), so two networks from one seed step alike
    _, a = _pair(jupd.Sgd(learning_rate=0.1), dropout_layer=0.5)
    _, b = _pair(jupd.Sgd(learning_rate=0.1), dropout_layer=0.5)
    _, c = _pair(jupd.Sgd(learning_rate=0.1))
    x, y, _ = _data(seed=19)
    for net in (a, b, c):
        net.fit_batch(x, y)
    assert torch.equal(a.params(), b.params())
    assert not torch.equal(a.params(), c.params())
    # scoring draws nothing: no dropout outside training
    assert a.score(TDataSet(x, y)) == a.score(TDataSet(x, y))


def _lstm_configure(**kw):
    return lambda n: __import__(
        "deeplearning4j_tpu_torch.ops.lstm_scan_fused",
        fromlist=["configure"]).configure(**kw)


UNPORTED = {
    "lstm_gate_math_native": (_lstm_configure(gate_math="native"),
                              "gate_math"),
    "lstm_grid": (_lstm_configure(grid="tm"), "no counterpart"),
    "configure_health": (lambda n: n.configure_health(None), "health"),
    "pretrain": (lambda n: n.pretrain(None), "pretrain"),
    "pretrain_layer": (lambda n: n.pretrain_layer(0, None), "pretrain"),
    "dq_partials_io": (lambda n: __import__(
        "deeplearning4j_tpu_torch.ops.flash_attention",
        fromlist=["configure"]).configure(dq_partials="io"), "dq_partials"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_option_raises(name):
    fn, match = UNPORTED[name]
    _, tnet = _pair(jupd.Sgd(learning_rate=0.1))
    with pytest.raises(NotImplementedError, match=match):
        fn(tnet)


def test_training_conf_json_round_trip():
    conf = _conf(jupd.Adam(learning_rate=0.01), layer_kw=dict(l2=0.1),
                 compute_dtype="bfloat16", remat=True)
    tconf = conf_from_json(conf.to_json())
    assert json.loads(tconf.to_json())["global_conf"] == \
        json.loads(conf.to_json())["global_conf"]
    assert isinstance(tconf.get_updater(), tupd.Adam)
    assert tconf.layers[0].l2 == 0.1
