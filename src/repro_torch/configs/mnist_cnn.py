"""The paper's local model: 7-layer CNN for 28x28x1 images, ~1.66M params.

Paper §6.1: "two layers of convolution layer, one layer of flattened layer,
two layers of max pooling layer, and two layers of the fully connected
layer ... about 1.66 million [trainable variables] ... 5.2 Mbytes".

Topology (chosen to hit 1.66M):
  conv 5x5x1->32, maxpool 2x2, conv 5x5x32->64, maxpool 2x2, flatten,
  fc 3136->512, fc 512->10.
Params = 832 + 51_264 + 1_606_144 + 5_130 = 1_663_370  (~1.66M, 6.65MB fp32;
the paper's 5.2MB suggests mixed precision on disk — noted, not replicated).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str = "mnist-cnn"
    image_size: int = 28
    channels: int = 1
    conv_channels: tuple = (32, 64)
    kernel_size: int = 5
    fc_width: int = 512
    num_classes: int = 10
    citation: str = "paper §6.1 (MNIST CNN, ~1.66M params)"


CONFIG = CNNConfig()
