"""Updaters (counterpart of nn/updater/updaters.py).

Each updater is a small configuration object with plain functions:

    init(params)                      -> state (same structure as params)
    update(grads, state, params, t)   -> (updates, new_state)

`updates` is the step to *subtract* from params. These are the JAX
package's formulas in torch ops, never `torch.optim`: DL4J puts epsilon
and the bias correction elsewhere than torch does. The scalars the JAX
package computes in float32 from the step counter `t` (scheduled learning
rates, the bias corrections) are computed in float32 here too, on the
host, so a float64 network steps exactly as the JAX one does.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.flat_params import tree_map

UPDATER_REGISTRY: dict = {}


def register_updater(cls):
    UPDATER_REGISTRY[cls.__name__] = cls
    return cls


def _tree_zeros(params):
    return tree_map(torch.zeros_like, params)


def _f32(x) -> np.float32:
    return np.float32(x)


def schedule_lr(lr, schedule: Optional[dict], t):
    """Apply a learning-rate policy dict {type, decay_rate, steps, power,
    ...} at step `t`. Without a schedule `lr` comes back as it is; with
    one the result is the JAX package's float32 value, as a Python
    float."""
    if not schedule:
        return lr
    kind = str(schedule.get("type", "none")).lower()
    t = _f32(t)
    if kind == "none":
        return lr
    if kind == "exponential":
        out = _f32(lr) * _f32(schedule.get("decay_rate", 0.99)) ** t
    elif kind == "step":
        steps = _f32(float(schedule.get("steps", 1000)))
        out = _f32(lr) * _f32(schedule.get("decay_rate", 0.1)) \
            ** np.floor(t / steps)
    elif kind == "inverse":
        gamma = _f32(float(schedule.get("gamma", 1e-3)))
        power = _f32(float(schedule.get("power", 0.75)))
        out = _f32(lr) * (_f32(1.0) + gamma * t) ** (-power)
    elif kind == "poly":
        power = _f32(float(schedule.get("power", 1.0)))
        max_iter = _f32(float(schedule.get("max_iter", 10000)))
        out = _f32(lr) * (_f32(1.0) - np.minimum(t / max_iter, _f32(1.0))) \
            ** power
    elif kind == "sigmoid":
        gamma = _f32(float(schedule.get("gamma", 1e-2)))
        steps = _f32(float(schedule.get("steps", 1000)))
        out = _f32(lr) / (_f32(1.0) + np.exp(-gamma * (t - steps)))
    else:
        raise ValueError(f"Unknown lr schedule: {kind}")
    return float(np.float32(out))


@dataclass
class BaseUpdater:
    learning_rate: float = 1e-3
    schedule: Optional[dict] = None

    def lr(self, t):
        return schedule_lr(self.learning_rate, self.schedule, t)

    def init(self, params):
        return {}

    def update(self, grads, state, params, t):
        raise NotImplementedError

    # ---- serde (the JAX package's dict, "@class" included) ----
    def to_dict(self):
        d = asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "BaseUpdater":
        d = dict(d)
        cls = UPDATER_REGISTRY[d.pop("@class")]
        return cls(**d)


def _corr(b: float, tt: np.float32) -> float:
    """1 - b ** tt in float32, as the JAX package computes it."""
    return float(np.float32(_f32(1.0) - _f32(b) ** tt))


@register_updater
@dataclass
class Sgd(BaseUpdater):
    learning_rate: float = 0.1

    def update(self, grads, state, params, t):
        lr = self.lr(t)
        return tree_map(lambda g: lr * g, grads), state


@register_updater
@dataclass
class NoOp(BaseUpdater):
    def update(self, grads, state, params, t):
        return tree_map(torch.zeros_like, grads), state


@register_updater
@dataclass
class Nesterovs(BaseUpdater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def init(self, params):
        return {"v": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        lr, mu = self.lr(t), self.momentum
        # DL4J Nesterov form: vNew = mu*v - lr*g; update = -(mu*vNew - lr*g)
        v_new = tree_map(lambda vi, g: mu * vi - lr * g, state["v"], grads)
        updates = tree_map(lambda vn, g: -(mu * vn - lr * g), v_new, grads)
        return updates, {"v": v_new}


@register_updater
@dataclass
class Adam(BaseUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        tt = _f32(t) + _f32(1.0)
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * g * g, state["v"],
                     grads)
        alpha = float(np.float32(_f32(self.lr(t)) * np.sqrt(_f32(_corr(
            b2, tt))) / _f32(_corr(b1, tt))))
        updates = tree_map(lambda mi, vi: alpha * mi / (torch.sqrt(vi) + eps),
                           m, v)
        return updates, {"m": m, "v": v}


@register_updater
@dataclass
class AdaMax(BaseUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _tree_zeros(params), "u": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        tt = _f32(t) + _f32(1.0)
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda ui, g: torch.maximum(b2 * ui, g.abs()),
                     state["u"], grads)
        alpha = float(np.float32(_f32(self.lr(t)) / _f32(_corr(b1, tt))))
        updates = tree_map(lambda mi, ui: alpha * mi / (ui + eps), m, u)
        return updates, {"m": m, "u": u}


@register_updater
@dataclass
class Nadam(BaseUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        lr = self.lr(t)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        tt = _f32(t) + _f32(1.0)
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * g * g, state["v"],
                     grads)
        c1_next, c1, c2 = (_corr(b1, tt + _f32(1.0)), _corr(b1, tt),
                           _corr(b2, tt))
        m_hat = tree_map(lambda mi, g: b1 * mi / c1_next + (1 - b1) * g / c1,
                         m, grads)
        v_hat = tree_map(lambda vi: vi / c2, v)
        updates = tree_map(lambda mh, vh: lr * mh / (torch.sqrt(vh) + eps),
                           m_hat, v_hat)
        return updates, {"m": m, "v": v}


@register_updater
@dataclass
class AdaGrad(BaseUpdater):
    learning_rate: float = 0.1
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        lr = self.lr(t)
        h = tree_map(lambda hi, g: hi + g * g, state["h"], grads)
        updates = tree_map(lambda hi, g: lr * g / (torch.sqrt(hi)
                                                   + self.epsilon), h, grads)
        return updates, {"h": h}


@register_updater
@dataclass
class RmsProp(BaseUpdater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"g2": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        lr, d = self.lr(t), self.rms_decay
        g2 = tree_map(lambda si, g: d * si + (1 - d) * g * g, state["g2"],
                      grads)
        updates = tree_map(lambda si, g: lr * g / torch.sqrt(
            si + self.epsilon), g2, grads)
        return updates, {"g2": g2}


@register_updater
@dataclass
class AdaDelta(BaseUpdater):
    rho: float = 0.95
    epsilon: float = 1e-6
    learning_rate: float = 1.0  # unused by the algorithm; kept for the API

    def init(self, params):
        return {"g2": _tree_zeros(params), "dx2": _tree_zeros(params)}

    def update(self, grads, state, params, t):
        rho, eps = self.rho, self.epsilon
        g2 = tree_map(lambda si, g: rho * si + (1 - rho) * g * g,
                      state["g2"], grads)
        updates = tree_map(
            lambda si, di, g: torch.sqrt(di + eps) / torch.sqrt(si + eps) * g,
            g2, state["dx2"], grads)
        dx2 = tree_map(lambda di, u: rho * di + (1 - rho) * u * u,
                       state["dx2"], updates)
        return updates, {"g2": g2, "dx2": dx2}


def updater_from_name(name: str, learning_rate: float = 0.1,
                      **kw) -> BaseUpdater:
    """DL4J `Updater` enum-style construction."""
    table = {
        "SGD": Sgd, "ADAM": Adam, "ADAMAX": AdaMax, "NADAM": Nadam,
        "ADADELTA": AdaDelta, "NESTEROVS": Nesterovs, "ADAGRAD": AdaGrad,
        "RMSPROP": RmsProp, "NONE": NoOp, "CUSTOM": Sgd,
    }
    cls = table[name.upper()]
    if cls is AdaDelta:
        kw.pop("learning_rate", None)
        return AdaDelta(**kw)
    return cls(learning_rate=learning_rate, **kw)
