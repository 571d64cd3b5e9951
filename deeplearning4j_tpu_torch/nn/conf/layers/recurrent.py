"""Recurrent layers (counterpart of nn/conf/layers/recurrent.py): LSTM,
GravesLSTM (peepholes), GravesBidirectionalLSTM, SimpleRnn, Bidirectional,
LastTimeStep and RnnOutputLayer.

Layout is the JAX package's recurrent layout, (batch, size, time); the
recurrence runs over (time, batch, size) with the fused weights' gate
order [input, forget, output, cell(g)]. Masking: a (batch, time) mask;
masked steps output zero and hold the recurrent state.

How an LSTM layer reaches the kernels (the JAX `LSTM._scan` dispatch):
- an unmasked sequence with sigmoid/tanh activations runs the whole
  recurrence through `ops.lstm_scan_fused.graves_lstm_scan` (K7 on the
  card; a plain LSTM passes zero peepholes), the reverse direction of a
  bidirectional layer on the time-flipped input projection;
- a masked sequence runs a per-step loop whose cell is
  `ops.lstm_gates.graves_gates` (K8) for peephole layers and
  `ops.lstm_gates.lstm_gates` (K9) for plain LSTM;
- other activations run the per-step loop with the cell written inline.
As the JAX package falls back when `fits_vmem` fails, an unmasked layer
whose H is too wide for K7's shared-memory tile on the card
(`lstm_scan_fused.scan_fits`, a shape rule read before the call) takes
the per-step loop through K8/K9.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.common.enums import Activation, LossFunction
from deeplearning4j_tpu_torch.nn.activations import apply_activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    BaseLayerConf, FeedForwardLayerConf, register_layer)
from deeplearning4j_tpu_torch.nn.losses import (compute_loss,
                                                compute_loss_per_example)
from deeplearning4j_tpu_torch.ops.lstm_gates import graves_gates, lstm_gates
from deeplearning4j_tpu_torch.ops.lstm_scan_fused import (graves_lstm_scan,
                                                          scan_fits)


def _directions(params):
    """The forward and backward parameter dicts of a bidirectional layer
    (keys suffixed _f and _b)."""
    return ({k[:-2]: v for k, v in params.items() if k.endswith("_f")},
            {k[:-2]: v for k, v in params.items() if k.endswith("_b")})


def _time_major(x):
    """(batch, size, time) -> (time, batch, size)."""
    return x.permute(2, 0, 1)


def _masked_loop(step, xw, mask, reverse, carry):
    """Run `step(xw_t, carry) -> (h_new, carry_new)` over the time axis of
    xw (T, B, ...), holding the carry where the (B, T) mask is 0 and
    outputting zero there. Returns (ys (T, B, n), final carry)."""
    T = xw.shape[0]
    mt = None if mask is None else \
        mask.t()[..., None].to(xw.dtype)           # (T, B, 1)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, new = step(xw[t], carry)
        if mt is None:
            carry, ys[t] = new, h_new
            continue
        m = mt[t]
        carry = tuple(m * a + (1 - m) * b for a, b in zip(new, carry))
        ys[t] = m * h_new
    return torch.stack(ys), carry


@register_layer
@dataclass
class LSTM(FeedForwardLayerConf):
    """LSTM without peepholes (the cuDNN-compatible formulation)."""
    activation: Activation = Activation.TANH
    gate_activation: Activation = Activation.SIGMOID
    forget_gate_bias_init: float = 1.0
    peephole: bool = False

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.size

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        n_in, n = self.n_in, self.n_out
        b = torch.zeros((4 * n,), dtype=dtype, device=device)
        b[n:2 * n] = self.forget_gate_bias_init
        p = {"W": self._winit(generator, (n_in, 4 * n), n_in, n, dtype,
                              device),
             "RW": self._winit(generator, (n, 4 * n), n, n, dtype, device),
             "b": b}
        if self.peephole:
            for k in ("pi", "pf", "po"):
                p[k] = torch.zeros((n,), dtype=dtype, device=device)
        return p

    def _standard(self) -> bool:
        return self.gate_activation == Activation.SIGMOID \
            and self.activation == Activation.TANH

    def _step(self, params, xw_t, h, c):
        """One step from xw_t = x_t W + b: (h_new, c_new)."""
        n = self.n_out
        gates = xw_t + h @ params["RW"]
        if self._standard():
            if self.peephole:
                c_new, h_new = graves_gates(gates, c, params["pi"],
                                            params["pf"], params["po"])
            else:
                c_new, h_new = lstm_gates(gates, c)
            return h_new, c_new
        zi, zf, zo, zg = (gates[:, :n], gates[:, n:2 * n],
                          gates[:, 2 * n:3 * n], gates[:, 3 * n:])

        def gact(v):
            return apply_activation(self.gate_activation, v)
        if self.peephole:
            i = gact(zi + c * params["pi"])
            f = gact(zf + c * params["pf"])
        else:
            i, f = gact(zi), gact(zf)
        c_new = f * c + i * apply_activation(self.activation, zg)
        o = gact(zo + c_new * params["po"]) if self.peephole else gact(zo)
        return o * apply_activation(self.activation, c_new), c_new

    def _scan(self, params, x, mask, h0=None, c0=None, reverse=False):
        """x (batch, size, time) -> (outputs (batch, n_out, time), final
        (h, c))."""
        B, n, dtype = x.shape[0], self.n_out, x.dtype
        h = torch.zeros((B, n), dtype=dtype, device=x.device) \
            if h0 is None else h0
        c = torch.zeros((B, n), dtype=dtype, device=x.device) \
            if c0 is None else c0
        xw = _time_major(x) @ params["W"] + params["b"]
        if mask is None and self._standard() \
                and scan_fits(n, dtype, x.device):
            zero = torch.zeros((n,), dtype=dtype, device=x.device)
            xw_k = xw.flip(0) if reverse else xw
            ys, cs = graves_lstm_scan(
                xw_k, params["RW"], params.get("pi", zero),
                params.get("pf", zero), params.get("po", zero), h, c)
            final = (ys[-1], cs[-1])
            if reverse:
                ys = ys.flip(0)
            return ys.permute(1, 2, 0), final

        def step(xw_t, carry):
            h_new, c_new = self._step(params, xw_t, *carry)
            return h_new, (h_new, c_new)
        ys, final = _masked_loop(step, xw, mask, reverse, (h, c))
        return ys.permute(1, 2, 0), final

    def forward(self, params, state, x, *, train=False, mask=None):
        out, _ = self._scan(params, x, mask)
        return out, state, mask


@register_layer
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013)."""
    peephole: bool = True


@register_layer
@dataclass
class GravesBidirectionalLSTM(LSTM):
    """Bidirectional Graves LSTM; the two directions are summed."""
    peephole: bool = True

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        fwd = super().init_params(generator, input_type, dtype, device)
        bwd = super().init_params(generator, input_type, dtype, device)
        p = {f"{k}_f": v for k, v in fwd.items()}
        p.update({f"{k}_b": v for k, v in bwd.items()})
        return p

    def forward(self, params, state, x, *, train=False, mask=None):
        pf, pb = _directions(params)
        out_f, _ = self._scan(pf, x, mask)
        out_b, _ = self._scan(pb, x, mask, reverse=True)
        return out_f + out_b, state, mask


@register_layer
@dataclass
class SimpleRnn(FeedForwardLayerConf):
    """Vanilla RNN: h_t = act(x_t W + h_{t-1} RW + b). No kernel: a plain
    loop, as the JAX package's lax.scan."""
    activation: Activation = Activation.TANH

    def get_output_type(self, input_type):
        return InputType.recurrent(
            self.n_out, getattr(input_type, "timeseries_length", -1))

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.size

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        n_in, n = self.n_in, self.n_out
        return {"W": self._winit(generator, (n_in, n), n_in, n, dtype,
                                 device),
                "RW": self._winit(generator, (n, n), n, n, dtype, device),
                "b": torch.full((n,), self.bias_init, dtype=dtype,
                                device=device)}

    def _scan(self, params, x, mask, h0=None, reverse=False):
        B = x.shape[0]
        h = torch.zeros((B, self.n_out), dtype=x.dtype, device=x.device) \
            if h0 is None else h0
        xw = _time_major(x) @ params["W"] + params["b"]

        def step(xw_t, carry):
            h_new = apply_activation(self.activation,
                                     xw_t + carry[0] @ params["RW"])
            return h_new, (h_new,)
        ys, (h,) = _masked_loop(step, xw, mask, reverse, (h,))
        return ys.permute(1, 2, 0), h

    def forward(self, params, state, x, *, train=False, mask=None):
        out, _ = self._scan(params, x, mask)
        return out, state, mask


@register_layer
@dataclass
class Bidirectional(BaseLayerConf):
    """Bidirectional wrapper around a recurrent layer; modes concat
    (default), add, mul, average combine the forward and time-reversed
    passes."""
    fwd: Optional[FeedForwardLayerConf] = None   # the wrapped layer's conf
    mode: str = "concat"

    def __post_init__(self):
        if isinstance(self.fwd, dict):
            self.fwd = BaseLayerConf.from_dict(self.fwd)

    @property
    def n_out(self):
        return 2 * self.fwd.n_out if self.mode == "concat" else self.fwd.n_out

    def set_n_in(self, input_type, override=False):
        self.fwd.set_n_in(input_type, override)

    def get_output_type(self, input_type):
        base = self.fwd.get_output_type(input_type)
        if self.mode == "concat":
            return InputType.recurrent(
                base.size * 2, getattr(base, "timeseries_length", -1))
        return base

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        f = self.fwd.init_params(generator, input_type, dtype, device)
        b = self.fwd.init_params(generator, input_type, dtype, device)
        p = {f"{k}_f": v for k, v in f.items()}
        p.update({f"{k}_b": v for k, v in b.items()})
        return p

    def forward(self, params, state, x, *, train=False, mask=None):
        pf, pb = _directions(params)
        out_f, _ = self.fwd._scan(pf, x, mask)
        out_b, _ = self.fwd._scan(pb, x, mask, reverse=True)
        if self.mode == "concat":
            out = torch.cat([out_f, out_b], dim=1)
        elif self.mode == "add":
            out = out_f + out_b
        elif self.mode == "mul":
            out = out_f * out_b
        elif self.mode == "average":
            out = 0.5 * (out_f + out_b)
        else:
            raise ValueError(f"unknown Bidirectional mode {self.mode!r}")
        return out, state, mask


@register_layer
@dataclass
class LastTimeStep(BaseLayerConf):
    """The last (unmasked) time step of the wrapped recurrent layer's
    output, as feed-forward activations."""
    underlying: Optional[FeedForwardLayerConf] = None

    def __post_init__(self):
        if isinstance(self.underlying, dict):
            self.underlying = BaseLayerConf.from_dict(self.underlying)

    @property
    def n_out(self):
        return self.underlying.n_out

    def set_n_in(self, input_type, override=False):
        self.underlying.set_n_in(input_type, override)

    def get_output_type(self, input_type):
        return InputType.feed_forward(
            self.underlying.get_output_type(input_type).size)

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        return self.underlying.init_params(generator, input_type, dtype,
                                           device)

    def forward(self, params, state, x, *, train=False, mask=None):
        out, ns, out_mask = self.underlying.forward(params, state, x,
                                                    train=train, mask=mask)
        if out_mask is None:
            return out[:, :, -1], ns, None
        idx = torch.clamp(out_mask.to(torch.int64).sum(1) - 1, min=0)
        last = torch.take_along_dim(out, idx[:, None, None], dim=2)[:, :, 0]
        return last, ns, None


@register_layer
@dataclass
class RnnOutputLayer(FeedForwardLayerConf):
    """Per-timestep dense + loss head over (batch, size, time)."""
    loss_fn: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.SOFTMAX
    has_bias: bool = True

    def is_output_layer(self):
        return True

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.size

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        p = {"W": self._winit(generator, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device)
        return p

    def preout(self, params, x):
        # (batch, size, time) -> (batch, n_out, time)
        z = torch.einsum("bst,so->bot", x, params["W"])
        if self.has_bias:
            z = z + params["b"][None, :, None]
        return z

    def forward(self, params, state, x, *, train=False, mask=None):
        z = self.preout(params, x)
        if self.activation == Activation.SOFTMAX:
            out = torch.softmax(z, dim=1)        # over the feature axis
        else:
            out = self._act(z)
        if mask is not None:
            out = out * mask[:, None, :].to(out.dtype)
        return out, state, mask

    def _score_args(self, params, x, labels, mask):
        """(labels, pre-activations, activation, mask) for the loss, as
        (batch * time, n_out) rows with the feature axis last."""
        z = self.preout(params, x).transpose(1, 2).reshape(-1, self.n_out)
        lab = labels.transpose(1, 2).reshape(-1, self.n_out)
        return lab, z, self.activation, \
            None if mask is None else mask.reshape(-1)

    def compute_score(self, params, x, labels, mask=None):
        """Mean loss over the (batch * time) rows."""
        return compute_loss(self.loss_fn, *self._score_args(
            params, x, labels, mask))

    def compute_score_per_example(self, params, x, labels, mask=None):
        """(batch,) scores: each example's loss summed over its unmasked
        timesteps (the scalar score normalizes by batch * time, so
        mean(per_example) / T == score)."""
        per_bt = compute_loss_per_example(
            self.loss_fn, *self._score_args(params, x, labels, mask))
        return per_bt.reshape(x.shape[0], -1).sum(dim=1)
