"""The paper's own benchmark models (DAWNBench CNNs) at CPU scale — the
port's copy of the JAX package's configs/resnet9_cifar.py."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    widths: tuple = (16, 32, 64)   # channels per stage
    classes: int = 10
    hw: int = 32
    channels: int = 3
    kind: str = "resnet9"          # resnet9 | alexnet | mlp


RESNET9 = CNNConfig(name="resnet9-cifar", widths=(16, 32, 64))
ALEXNET = CNNConfig(name="alexnet-cifar", widths=(16, 32, 64),
                    kind="alexnet")
MLP = CNNConfig(name="mlp-cifar", widths=(256, 128), kind="mlp")
