"""Models of the port: the paper's CNNs (models/cnn.py) and the LM
families' train path on one device (the JAX package's models/__init__
exports)."""
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.dist import DistConfig
from repro_torch.models.model import Model, declare_params
