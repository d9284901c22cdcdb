"""SimCluster: the fault-injected scenario harness for the simulated
cluster (the JAX package's sim/): hashable Scenario specs (heterogeneous
links, stragglers, elastic world size, non-IID shards, wire corruption)
around the Algorithm-1 aggregation path, never touching its numerics.
See repro_torch/scenarios.py for the campaign runner."""
from repro_torch.sim.scenario import (DEFAULT_ALPHA_US, DEFAULT_GBPS,
                                      CorruptionSpec, LinkSpec, RescaleEvent,
                                      Scenario, StragglerSpec)
from repro_torch.sim.cluster import SimCluster, init_ef
