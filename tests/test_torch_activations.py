"""Every activation of the enum: the port's value and torch.autograd
gradient against the JAX package's value and jax.grad, in float64 on the
CPU, at each function's kink points and at random points. Tolerance
1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.enums import Activation as JaxActivation
from deeplearning4j_tpu.nn.activations import get_activation as jax_act
from deeplearning4j_tpu_torch.common.enums import Activation
from deeplearning4j_tpu_torch.nn.activations import get_activation

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

TOL = 1e-12
KINKS = [-6.0, -3.0, -1.0, 0.0, 1.0, 3.0, 6.0]


@pytest.mark.parametrize("act", list(Activation), ids=lambda a: a.value)
def test_activation_value_and_gradient_match_jax(act):
    rng = np.random.RandomState(3)
    pts = np.concatenate([KINKS, rng.uniform(-8.0, 8.0, 41)])
    if act == Activation.SOFTMAX:
        x = pts.reshape(-1, 6)[:8]           # softmax over the last axis
        cot = rng.standard_normal(x.shape)
    else:
        x, cot = pts, np.ones_like(pts)
    jf = jax_act(JaxActivation(act.value))
    jy, vjp = jax.vjp(jf, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    ty = get_activation(act)(xt)
    (tg,) = torch.autograd.grad(ty, xt, torch.tensor(cot))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)
