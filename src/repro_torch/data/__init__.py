"""Synthetic data of the port (the JAX package's data/ exports that the
port has so far)."""
from repro_torch.data.synthetic import classification_batch
