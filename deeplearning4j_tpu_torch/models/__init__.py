"""Model zoo (counterpart of deeplearning4j_tpu/models): the architectures
whose layers are ported. The rest of the JAX zoo (AlexNet, VGG, GoogLeNet,
...) waits for its layers (ROADMAP.md)."""
from deeplearning4j_tpu_torch.models.lenet import LeNet
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50
from deeplearning4j_tpu_torch.models.simple_cnn import (SimpleCNN,
                                                        TextGenerationLSTM)
from deeplearning4j_tpu_torch.models.zoo_model import ZooModel

__all__ = ["LeNet", "ResNet50", "SimpleCNN", "TextGenerationLSTM",
           "ZooModel"]
