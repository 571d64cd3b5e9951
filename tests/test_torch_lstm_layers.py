"""The port's recurrent layers against the JAX package's, in float64 on the
CPU.

Each layer is built from the JAX layer's dict and given the JAX parameters
(peepholes made non-zero); outputs and gradients (parameters and input)
are compared with the JAX layer run with its helpers off (lax.scan, jnp
cells) and on (the Pallas scan and gate kernels in interpret mode), masked
and unmasked. In the port an unmasked standard LSTM runs the K7 scan's
plain version and a masked one the K8 / K9 cells' plain versions.
The bidirectional layers are in test_torch_lstm_bidirectional.py.
Tolerance 1e-10.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deeplearning4j_tpu.ops.lstm_scan_fused  # noqa: F401  (registers it)
from deeplearning4j_tpu import Activation, InputType
from deeplearning4j_tpu.nn.conf.layers import recurrent as jrec
from deeplearning4j_tpu.ops.helpers import helpers_enabled_ctx
from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayerConf

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

LAYER_TOL = 1e-10
B, N_IN, T = 3, 3, 6


def _layers():
    return {
        "lstm": jrec.LSTM(n_in=N_IN, n_out=4),
        "graves_lstm": jrec.GravesLSTM(n_in=N_IN, n_out=4),
        "graves_bidirectional": jrec.GravesBidirectionalLSTM(n_in=N_IN,
                                                             n_out=4),
        "lstm_hardsigmoid": jrec.LSTM(
            n_in=N_IN, n_out=4, gate_activation=Activation.HARDSIGMOID),
        "graves_softsign": jrec.GravesLSTM(n_in=N_IN, n_out=4,
                                           activation=Activation.SOFTSIGN),
        "simple_rnn": jrec.SimpleRnn(n_in=N_IN, n_out=4),
        "bidirectional_concat": jrec.Bidirectional(
            fwd=jrec.GravesLSTM(n_in=N_IN, n_out=4)),
        "bidirectional_add": jrec.Bidirectional(
            fwd=jrec.LSTM(n_in=N_IN, n_out=4), mode="add"),
        "bidirectional_mul": jrec.Bidirectional(
            fwd=jrec.SimpleRnn(n_in=N_IN, n_out=4), mode="mul"),
        "bidirectional_average": jrec.Bidirectional(
            fwd=jrec.GravesLSTM(n_in=N_IN, n_out=4), mode="average"),
        "last_time_step": jrec.LastTimeStep(
            underlying=jrec.GravesLSTM(n_in=N_IN, n_out=4)),
    }


def _mask(rng):
    m = np.ones((B, T))
    m[1, 4:] = 0
    m[2, 2:] = 0
    m[0, 3] = 0                     # a hole: the state holds through it
    return m


def two_way(name: str) -> bool:
    return "bidirectional" in name


MODES = [pytest.param(m, h, id=f"{'masked' if m else 'unmasked'}-helpers_"
                      f"{'on' if h else 'off'}")
         for m in (False, True) for h in (False, True)]


@pytest.mark.parametrize("masked,helpers", MODES)
@pytest.mark.parametrize("name", sorted(n for n in _layers()
                                        if not two_way(n)))
def test_recurrent_layer_matches_jax(name, masked, helpers):
    check_layer(name, masked, helpers)


def check_layer(name, masked, helpers):
    """Outputs and gradients of layer `name` against the JAX layer's."""
    jl = _layers()[name]
    params = jl.init_params(jax.random.PRNGKey(7),
                            InputType.recurrent(N_IN), jnp.float64)
    if "pi" in params or "pi_f" in params:           # non-zero peepholes
        params = {k: v + 0.3 * jnp.sin(jnp.arange(v.size) + 1.0)
                  if k[:2] in ("pi", "pf", "po") else v
                  for k, v in params.items()}
    tl = BaseLayerConf.from_dict(jl.to_dict())
    rng = np.random.RandomState(len(name))
    x = rng.randn(B, N_IN, T)
    mask = _mask(rng) if masked else None
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, _, _ = tl.forward(tp, {}, tx, train=True,
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    r = rng.randn(*tout.shape)
    grads = torch.autograd.grad((tout * torch.from_numpy(r)).sum(),
                                [tx] + list(tp.values()))

    def jloss(p, xx):
        out, _, _ = jl.forward(p, {}, xx, train=True,
                               mask=None if mask is None
                               else jnp.asarray(mask))
        return (out * r).sum(), out

    with helpers_enabled_ctx(helpers):
        (_, jout), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=LAYER_TOL, rtol=0)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               atol=LAYER_TOL, rtol=0, err_msg="dx")
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]),
                                   atol=LAYER_TOL, rtol=0, err_msg=k)
