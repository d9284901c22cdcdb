"""Synthetic data of the port (the JAX package's data/ exports that the
port has so far)."""
from repro_torch.data.synthetic import (classification_batch, frames_stub,
                                        lm_batches, make_markov,
                                        markov_lm_batch, patches_stub)
