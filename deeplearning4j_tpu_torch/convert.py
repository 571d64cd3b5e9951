"""Carry a network over from the JAX package.

- `conf_from_json(jax_conf.to_json())`: the port's MultiLayerConfiguration
  from the JAX package's JSON (same schema, same layer names and fields);
  `graph_conf_from_json` the same for a ComputationGraphConfiguration.
- `params_from_jax(net.params_tree)`: the port's parameter list from the
  JAX network's (a list of dicts of arrays). Names stay `w_q`, `w_k`,
  `w_v`, `w_o`, `b`, `W`, the recurrent `RW` and peepholes `pi`/`pf`/`po`
  (with `_f`/`_b` suffixes in bidirectional layers), and so does the JAX
  (n_in, n_out) layout with the gate order [i|f|o|g]: the port applies
  weights as `x @ W`, so nothing is transposed anywhere.
- `states_from_jax(net.state_tree)`: the layer state (BatchNormalization's
  running mean and var), one dict per layer.
- `opt_state_from_jax(net._opt_state)`: the updater state (Adam's m/v,
  RmsProp's running mean of squares, ...) in the same nest of lists and
  dicts, so a port network resumes
  training where the JAX one stopped (`net._opt_state = ...`).

A ComputationGraph's lists follow its layer nodes in topological order,
the same order in both packages, so the same functions carry a graph over.

Only numpy crosses between the packages: this module imports neither JAX
nor the JAX package, and takes anything `numpy.asarray` accepts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_configuration import \
    ComputationGraphConfiguration


def conf_from_json(s: str) -> MultiLayerConfiguration:
    return MultiLayerConfiguration.from_json(s)


def graph_conf_from_json(s: str) -> ComputationGraphConfiguration:
    return ComputationGraphConfiguration.from_json(s)


def params_from_jax(params_tree: Sequence[Dict[str, object]],
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None
                    ) -> List[Dict[str, torch.Tensor]]:
    """One dict of tensors per layer, copied from the JAX params (dtype
    kept unless `dtype` is given)."""
    dev = resolve_device(device)
    out = []
    for layer_params in params_tree:
        p = {}
        for name, v in layer_params.items():
            t = torch.from_numpy(np.array(np.asarray(v), copy=True))
            p[name] = t.to(dev, dtype) if dtype is not None else t.to(dev)
        out.append(p)
    return out


def _nest_from_jax(node, dev, dtype):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _nest_from_jax(v, dev, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_nest_from_jax(v, dev, dtype) for v in node)
    t = torch.from_numpy(np.array(np.asarray(node), copy=True))
    return t.to(dev, dtype) if dtype is not None else t.to(dev)


def states_from_jax(state_tree, device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None):
    """The port's layer states from the JAX network's `state_tree` (one
    dict per layer, {} for a stateless layer), arrays copied to
    tensors."""
    return _nest_from_jax(list(state_tree), resolve_device(device), dtype)


def opt_state_from_jax(opt_state_tree, device: DeviceLike = "cuda",
                       dtype: Optional[torch.dtype] = None):
    """The port's updater state from the JAX network's `_opt_state` (one
    nest of dicts per layer, e.g. {"m": {...}, "v": {...}} for Adam, {}
    for Sgd), structure and keys kept, arrays copied to tensors."""
    return _nest_from_jax(list(opt_state_tree), resolve_device(device),
                          dtype)
