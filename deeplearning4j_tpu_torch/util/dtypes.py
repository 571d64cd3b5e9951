"""Mixed-precision helper (counterpart of util/dtypes.py).

Params and updater state live in the storage dtype (float32 by default);
layer compute may run in a lower `compute_dtype` (bfloat16). The output
layer's score and the regularization always run in the storage dtype.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.util.flat_params import tree_map


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating-point tensor of a nest to `dtype`; leave the
    others (ints, bools, non-tensors) as they are."""
    return tree_map(lambda a: a.to(dtype) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a, tree)
