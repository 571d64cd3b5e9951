"""MultiLayerNetwork, inference only (counterpart of nn/multilayer.py).

`init`, `output` and `feed_forward` are ported; `fit`, scoring and the
updaters wait for the training slice. Parameters are a list (one entry per
layer) of dicts of tensors under the JAX package's names and layouts
(`W` and `w_*` are (n_in, n_out), applied as `x @ W`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a JAX/numpy dtype name ("float32", "bfloat16", ...)
    or a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = "cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers = conf.layers
        self.params_tree: List[Dict[str, torch.Tensor]] = []
        self.state_tree: List[Dict[str, Any]] = []
        self._initialized = False
        gc = conf.global_conf
        self.dtype = torch_dtype(gc.dtype)
        self.compute_dtype = torch_dtype(gc.compute_dtype) \
            if gc.compute_dtype else self.dtype

    def init(self, params: Optional[Sequence[Dict[str, Any]]] = None,
             generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        """Initialize parameters: copies of `params` (tensors or arrays, one
        dict per layer) when given, else fresh draws from `generator`
        (default: a CPU generator seeded with the configuration's seed, so
        the weights do not depend on the device)."""
        if generator is None:
            generator = torch.Generator().manual_seed(
                self.conf.global_conf.seed)
        input_types = self.conf.input_types_per_layer()
        self.params_tree, self.state_tree = [], []
        for i, layer in enumerate(self.layers):
            if params is not None:
                p = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                        v, torch.Tensor) else v).to(self.device, self.dtype,
                                                    copy=True)
                     for k, v in params[i].items()}
            elif layer.has_params():
                p = layer.init_params(generator, input_types[i], self.dtype,
                                      self.device)
            else:
                p = {}
            self.params_tree.append(p)
            self.state_tree.append(layer.init_state(input_types[i]))
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("Call net.init() first")

    def _forward(self, x, collect: bool):
        cd = self.compute_dtype
        params = self.params_tree if cd == self.dtype else [
            {k: v.to(cd) for k, v in p.items()} for p in self.params_tree]
        cur = x.to(cd)
        acts = [x]
        mask = None
        for i, layer in enumerate(self.layers):
            cur, _, mask = layer.forward(params[i], self.state_tree[i], cur,
                                         train=False, mask=mask)
            if collect:
                acts.append(cur)
        return cur.to(self.dtype), acts

    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Inference forward pass over the whole stack."""
        self._check_init()
        x = torch.as_tensor(x).to(self.device, self.dtype)
        return self._forward(x, collect=False)[0]

    @torch.no_grad()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations, input first."""
        self._check_init()
        x = torch.as_tensor(x).to(self.device, self.dtype)
        return self._forward(x, collect=True)[1]
