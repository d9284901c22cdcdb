"""Model configurations of the port: resnet9_cifar's CNNs and the ten LM
architectures of the registry."""
from repro_torch.configs.registry import (ARCH_NAMES, all_pairs,
                                          config_for_shape, get_config,
                                          get_long_context, get_smoke)
