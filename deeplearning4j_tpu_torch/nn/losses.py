"""Loss functions (counterpart of nn/losses.py).

Each loss takes the *pre-activation* output `z` of the output layer and
the layer's activation, so softmax+MCXENT and sigmoid+XENT use the fused,
numerically stable forms, as the JAX package does.

Conventions (the JAX package's):
- the per-example loss is summed over the output dimensions;
- the score is the mean over examples (the network adds L1/L2 terms);
- `mask` broadcasts to the label shape; masked entries contribute zero and
  the mean still divides by the number of examples (rows), so masked and
  unmasked training see the same loss scale.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from deeplearning4j_tpu_torch.common.enums import Activation, LossFunction
from deeplearning4j_tpu_torch.nn.activations import apply_activation

_EPS = 1e-7


def _sum_per_example(x: torch.Tensor) -> torch.Tensor:
    """Sum all dims except the leading (example) dim."""
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def compute_loss(loss_fn: Union[LossFunction, str], labels: torch.Tensor,
                 z: torch.Tensor, activation: Union[Activation, str, None],
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-over-examples scalar loss from pre-activations `z`."""
    return compute_loss_per_example(loss_fn, labels, z, activation,
                                    mask).mean()


def compute_loss_per_example(loss_fn: Union[LossFunction, str],
                             labels: torch.Tensor, z: torch.Tensor,
                             activation: Union[Activation, str, None],
                             mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(batch,) per-example losses from pre-activations `z`: each
    example's loss summed over its outputs (masked entries dropped); the
    scalar score is exactly the mean of this vector."""
    if isinstance(loss_fn, str):
        loss_fn = LossFunction(loss_fn.lower())
    if isinstance(activation, str):
        activation = Activation(activation.lower())

    if loss_fn in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        if activation == Activation.SOFTMAX:
            per_elem = -labels * torch.log_softmax(z, dim=-1)
        else:
            out = torch.clamp(apply_activation(activation, z), _EPS,
                              1.0 - _EPS)
            per_elem = -labels * torch.log(out)
    elif loss_fn == LossFunction.SPARSE_MCXENT:
        # labels are integer class ids with shape z.shape[:-1]
        logp = torch.log_softmax(z, dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])
        per_elem = nll
    elif loss_fn == LossFunction.XENT:
        if activation == Activation.SIGMOID:
            # stable: max(z,0) - z*y + log(1+exp(-|z|))
            per_elem = torch.clamp(z, min=0) - z * labels + torch.log1p(
                torch.exp(-z.abs()))
        else:
            out = torch.clamp(apply_activation(activation, z), _EPS,
                              1.0 - _EPS)
            per_elem = -(labels * torch.log(out)
                         + (1 - labels) * torch.log1p(-out))
    else:
        out = apply_activation(activation, z)
        if loss_fn in (LossFunction.MSE, LossFunction.L2):
            per_elem = (labels - out) ** 2
        elif loss_fn == LossFunction.L1:
            per_elem = (labels - out).abs()
        elif loss_fn == LossFunction.HINGE:          # labels in {-1, +1}
            per_elem = torch.clamp(1.0 - labels * out, min=0.0)
        elif loss_fn == LossFunction.SQUARED_HINGE:
            per_elem = torch.clamp(1.0 - labels * out, min=0.0) ** 2
        elif loss_fn == LossFunction.KL_DIVERGENCE:
            lc = torch.clamp(labels, _EPS, 1.0)
            oc = torch.clamp(out, _EPS, 1.0)
            per_elem = lc * (torch.log(lc) - torch.log(oc))
        elif loss_fn == LossFunction.POISSON:
            per_elem = out - labels * torch.log(torch.clamp(out, min=_EPS))
        elif loss_fn == LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR:
            per_elem = 100.0 * ((labels - out) / torch.clamp(
                labels.abs(), min=_EPS)).abs()
        elif loss_fn == LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR:
            per_elem = (torch.log1p(torch.clamp(out, min=-1 + _EPS))
                        - torch.log1p(torch.clamp(labels, min=-1 + _EPS))
                        ) ** 2
        elif loss_fn == LossFunction.COSINE_PROXIMITY:
            ln = labels / torch.clamp(
                torch.linalg.vector_norm(labels, dim=-1, keepdim=True),
                min=_EPS)
            on = out / torch.clamp(
                torch.linalg.vector_norm(out, dim=-1, keepdim=True),
                min=_EPS)
            per_ex = -(ln * on).reshape(labels.shape[0], -1).sum(dim=-1)
            if mask is not None:
                per_ex = per_ex * mask.reshape(mask.shape[0], -1)[:, 0]
            return per_ex
        else:
            raise ValueError(f"Unsupported loss function: {loss_fn}")

    if mask is not None:
        m = mask.reshape(tuple(mask.shape) + (1,) * (per_elem.ndim
                                                     - mask.ndim))
        per_elem = per_elem * m.expand(per_elem.shape).to(per_elem.dtype)
    return _sum_per_example(per_elem)
