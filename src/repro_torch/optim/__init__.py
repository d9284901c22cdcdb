"""Optimizers and learning-rate schedules of the port (the JAX package's
optim/)."""
from repro_torch.optim.optimizers import (OptConfig, init_opt_state,
                                          apply_updates, sgd, momentum, adam)
from repro_torch.optim.schedules import piecewise_linear, constant, cosine
