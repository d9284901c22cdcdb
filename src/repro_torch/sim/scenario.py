"""Scenario: a hashable fault-injection spec for the simulated cluster
(the JAX package's sim/scenario.py, the same classes, validation messages
and describe() strings; numpy only).

The campaign's question (the paper's, under hostile conditions) is
whether the layerwise-vs-entire-model verdict survives realistic system
behavior: heterogeneous links, stragglers, elastic world size, non-IID
shards. A `Scenario` names one such condition set. It is a frozen value
object — floats and tuples only — so it hashes, keys caches, and prints
itself into the campaign's report verbatim.

The contract every knob obeys (tests/test_torch_scenarios.py): at its IDENTITY
setting a knob changes NOTHING — `SimCluster.aggregate` stays bit-
identical to the bare `aggregate_simulated_workers`, and a rescale to
the current world size is a no-op on EF state. Faults act on two planes
only:

  * TIME — per-worker link alpha/beta and straggler delay draws feed the
    deterministic `simulate_schedule` alpha-beta model (exposed-comm
    accounting), never the step's numerics;
  * SHAPE/DATA — elastic rescale changes the worker axis between steps
    (EF residuals re-bucketed through ckpt/), Dirichlet skew changes
    which samples a worker sees (data/synthetic.py), never how a fixed
    set of worker gradients aggregates;
  * WIRE (the one deliberate exception) — `CorruptionSpec` perturbs the
    packed uint8 bytes a RECEIVER decodes (resil.FaultInjector via
    SimCluster.injector()), the regime the integrity checksum +
    recovery policies exist for. At prob 0 it injects nothing and the
    identity contract holds unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: the alpha-beta defaults of core.schedule.simulate_schedule — an empty
#: `links` tuple means every worker rides this homogeneous link.
DEFAULT_ALPHA_US = 50.0
DEFAULT_GBPS = 12.5


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One worker's network link: per-message latency (alpha, us) and
    bandwidth (beta, GB/s) — the two parameters of the calibrated
    pipeline model."""
    alpha_us: float = DEFAULT_ALPHA_US
    gbps: float = DEFAULT_GBPS

    def __post_init__(self):
        if not (self.alpha_us >= 0 and self.gbps > 0):
            raise ValueError(f"bad link {self!r}")


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """Per-step per-worker delay injection: each worker independently
    straggles with probability `prob`, adding `delay_us` of exposed
    (non-overlappable) time to its step. Draws are a pure function of
    (seed, step) — replaying a scenario replays its stragglers."""
    prob: float = 0.0
    delay_us: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"straggler prob must be in [0,1]: {self.prob}")
        if self.delay_us < 0:
            raise ValueError(f"negative straggler delay: {self.delay_us}")

    def draws(self, step: int, n_workers: int) -> np.ndarray:
        """(n_workers,) float64 delay in us charged to each worker at
        `step`. Identity (prob or delay 0) is exact zeros."""
        if self.prob <= 0.0 or self.delay_us <= 0.0:
            return np.zeros((n_workers,))
        rng = np.random.default_rng((self.seed, int(step)))
        hit = rng.random(n_workers) < self.prob
        return np.where(hit, self.delay_us, 0.0)


#: corruption modes resil.faults implements ("bitflip"/"truncate" hit
#: any received message; "drop_hop"/"dup_hop" need the ring topology)
CORRUPTION_MODES = ("bitflip", "truncate", "drop_hop", "dup_hop")


@dataclasses.dataclass(frozen=True)
class CorruptionSpec:
    """Data-plane wire corruption: with probability `prob` per received
    message (or per ring hop), perturb its packed uint8 bytes AFTER
    encode — `n_bits` seeded bit flips, a truncated (zeroed) tail, a
    dropped (zeroed) hop, or a duplicated (stale) hop. Draws are a pure
    function of (step key, seed, message tag): replaying a scenario
    replays its corruption byte for byte. Identity (prob 0) injects
    nothing and must keep the aggregate bit-identical."""
    prob: float = 0.0
    mode: str = "bitflip"
    n_bits: int = 1
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"corruption prob must be in [0,1]: "
                             f"{self.prob}")
        if self.mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}; "
                             f"expected one of {CORRUPTION_MODES}")
        if self.n_bits < 1:
            raise ValueError(f"n_bits must be >= 1: {self.n_bits}")

    def is_identity(self) -> bool:
        return self.prob <= 0.0


@dataclasses.dataclass(frozen=True)
class RescaleEvent:
    """Elastic world-size change: BEFORE running `step`, the cluster
    becomes `world_size` workers (EF state re-bucketed through ckpt/)."""
    step: int
    world_size: int

    def __post_init__(self):
        if self.step < 0 or self.world_size < 1:
            raise ValueError(f"bad rescale event {self!r}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named condition set for the simulated cluster.

    `links` is indexed per worker slot (cycled when shorter than the
    current world size, so elastic rescales keep a well-defined link per
    slot); empty = homogeneous default link. `dirichlet_alpha` is the
    non-IID shard-skew concentration (None = IID split); smaller alpha
    means more skew.
    """
    name: str = "clean"
    n_workers: int = 4
    links: Tuple[LinkSpec, ...] = ()
    straggler: StragglerSpec = StragglerSpec()
    rescales: Tuple[RescaleEvent, ...] = ()
    dirichlet_alpha: Optional[float] = None
    data_seed: int = 0
    corruption: CorruptionSpec = CorruptionSpec()

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1: {self.n_workers}")
        if self.dirichlet_alpha is not None and self.dirichlet_alpha <= 0:
            raise ValueError(
                f"dirichlet_alpha must be > 0 or None: {self.dirichlet_alpha}")
        if list(self.rescales) != sorted(self.rescales,
                                         key=lambda e: e.step):
            raise ValueError("rescale events must be sorted by step")

    # ------------------------------------------------------------------
    def link(self, worker: int) -> LinkSpec:
        if not self.links:
            return LinkSpec()
        return self.links[worker % len(self.links)]

    def world_size_at(self, step: int) -> int:
        """World size in effect while running `step` (a RescaleEvent at
        step s applies from s onward)."""
        n = self.n_workers
        for ev in self.rescales:
            if step >= ev.step:
                n = ev.world_size
        return n

    def is_identity(self) -> bool:
        """True when every knob sits at the setting that must reproduce
        the un-wrapped path bit for bit."""
        return (not self.links
                and (self.straggler.prob <= 0.0
                     or self.straggler.delay_us <= 0.0)
                and all(ev.world_size == self.n_workers
                        for ev in self.rescales)
                and self.dirichlet_alpha is None
                and self.corruption.is_identity())

    def describe(self) -> str:
        parts = [f"n={self.n_workers}"]
        if self.links:
            parts.append(f"links={len(self.links)}")
        if self.straggler.prob > 0 and self.straggler.delay_us > 0:
            parts.append(f"straggle(p={self.straggler.prob},"
                         f"{self.straggler.delay_us}us)")
        if self.rescales:
            parts.append("rescale:" + "->".join(
                str(ev.world_size) for ev in self.rescales))
        if self.dirichlet_alpha is not None:
            parts.append(f"dirichlet={self.dirichlet_alpha}")
        if not self.corruption.is_identity():
            parts.append(f"corrupt({self.corruption.mode},"
                         f"p={self.corruption.prob})")
        return f"{self.name}[{' '.join(parts)}]"
