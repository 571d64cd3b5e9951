"""Model zoo (counterpart of deeplearning4j_tpu/models): the architectures
whose layers are ported. The rest of the JAX zoo (SimpleCNN, LeNet, VGG,
ResNet50, ...) waits for the convolutional slice (ROADMAP.md)."""
from deeplearning4j_tpu_torch.models.simple_cnn import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.zoo_model import ZooModel

__all__ = ["TextGenerationLSTM", "ZooModel"]
