"""Synthetic data of the port (the JAX package's data/ exports)."""
from repro_torch.data.synthetic import (classification_batch,
                                        dirichlet_proportions, frames_stub,
                                        lm_batches, make_markov,
                                        markov_lm_batch,
                                        noniid_classification_batch,
                                        noniid_markov_lm_batch, patches_stub)
