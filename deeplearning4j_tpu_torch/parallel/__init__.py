"""Data-parallel training over a mesh of replicas and the gradient-sharing
accumulators (counterpart of parallel/)."""
from deeplearning4j_tpu_torch.parallel.accumulation import (
    BasicGradientsAccumulator, EncodedGradientsAccumulator,
    GradientsAccumulator, threshold_encode, threshold_encode_list)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, make_mesh
from deeplearning4j_tpu_torch.parallel.parallel_wrapper import (
    ParallelWrapper, TrainingMode)

__all__ = ["BasicGradientsAccumulator", "EncodedGradientsAccumulator",
           "GradientsAccumulator", "threshold_encode", "threshold_encode_list",
           "Mesh", "make_mesh",
           "ParallelWrapper", "TrainingMode"]
