"""Carry a network over from the JAX package.

- `conf_from_json(jax_conf.to_json())`: the port's MultiLayerConfiguration
  from the JAX package's JSON (same schema, same layer names and fields).
- `params_from_jax(net.params_tree)`: the port's parameter list from the
  JAX network's (a list of dicts of arrays). Names stay `w_q`, `w_k`,
  `w_v`, `w_o`, `b`, `W`, and so does the JAX (n_in, n_out) layout: the
  port applies weights as `x @ W`, so nothing is transposed anywhere.

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


def conf_from_json(s: str) -> MultiLayerConfiguration:
    return MultiLayerConfiguration.from_json(s)


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
