"""In-step compression telemetry over UnitPlan size-class buckets (the JAX
package's control/telemetry.py).

The control plane's sensors. A `TelemetryState` is a small tuple of f32
tensors carried through the train step; `measure` produces a one-step
increment by ONE extra compressor pass per size-class bucket of a fixed
*measurement plan* (always the layerwise plan of the gradient tree, so
the state's shapes never change when the controller switches the
*execution* granularity) plus one pass on the flat gradient (the
entire-model counterfactual). The gathers are the plan's own run
decomposition (core/plan.py `_gather_runs`), and the keys its own fold
tables (`unit_keys`), so the measured Q_W stream is the executed one.

Measured per size class b (all sums over the bucket's (n_units, dim) rows):

  grad_sum / grad_sumsq    sum x, sum x^2  -- gradient norm & entry variance
  qw_sumsq                 sum Q_W(x)^2    -- Omega_hat = qw_sumsq /
                                              grad_sumsq - 1
  qw_errsq                 sum (Q_W(x) - x)^2 -- per-unit compression error
  agg_errsq                sum (y - x)^2   -- end-to-end pipeline error (y =
                                              the aggregated gradient the
                                              step applied)

plus the same three second moments for the whole flat gradient compressed
as ONE unit (`em_*`), the signal `GranularitySwitchPolicy` compares
against the layer-wise trace.

The sums run in torch's order, not XLA's: every field agrees with the
reference's within 1e-5 relative (ROADMAP Queue 3 item 16). `summarize`
runs on the host at re-plan boundaries and produces plain-Python JSON.
"""
from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.convert import tree_leaves
from repro_torch.core.compressors import Compressor
from repro_torch.core.granularity import Granularity
from repro_torch.core.plan import UnitPlan, build_plan
from repro_torch.random import fold_in

_EPS = 1e-30

#: version stamp of the controller's exported JSON (report()/--telemetry-out).
#: v2: added schema_version + the self-describing "active" decision block.
TELEMETRY_SCHEMA_VERSION = 2


class TelemetryState(NamedTuple):
    """Accumulated per-size-class statistics (f32 tensors).

    `B` below is the number of size-class buckets of the measurement plan;
    scalars are 0-d. All fields are running sums over the accumulation
    window except `steps` (the window length).
    """
    steps: torch.Tensor        # ()  number of accumulated steps
    grad_sum: torch.Tensor     # (B,) sum x
    grad_sumsq: torch.Tensor   # (B,) sum x^2
    qw_sumsq: torch.Tensor     # (B,) sum Q_W(x)^2
    qw_errsq: torch.Tensor     # (B,) sum (Q_W(x) - x)^2
    agg_errsq: torch.Tensor    # (B,) sum (y - x)^2 (zero without y)
    em_sumsq: torch.Tensor     # ()  |x_flat|^2
    em_qw_sumsq: torch.Tensor  # ()  |Q_W(x_flat)|^2
    em_errsq: torch.Tensor     # ()  |Q_W(x_flat) - x_flat|^2


def measurement_plan(tree, stacked) -> UnitPlan:
    """The fixed layer-wise UnitPlan telemetry is measured over.

    Independent of the *active* execution granularity, so TelemetryState
    shapes are stable across controller decisions."""
    return build_plan(tree, stacked, Granularity("layerwise"))


def init_telemetry(mplan: UnitPlan, device="cpu") -> TelemetryState:
    z = torch.zeros((mplan.num_dispatches,), dtype=torch.float32,
                    device=device)
    s = torch.zeros((), dtype=torch.float32, device=device)
    return TelemetryState(steps=s, grad_sum=z, grad_sumsq=z, qw_sumsq=z,
                          qw_errsq=z, agg_errsq=z, em_sumsq=s,
                          em_qw_sumsq=s, em_errsq=s)


def accumulate(state: TelemetryState, inc: TelemetryState) -> TelemetryState:
    """state + inc field by field, on the increment's device (a fresh
    window starts on the CPU and moves to the step's device here)."""
    return TelemetryState(*(s.to(i.device) + i for s, i in zip(state, inc)))


def _sumsq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v)


def measure(mplan: UnitPlan, qw: Compressor, grads, key: torch.Tensor,
            grads_hat=None, entire_model: bool = True) -> TelemetryState:
    """One-step telemetry increment for `grads` (and optionally the
    aggregated output `grads_hat` the step actually applied).

    Uses the plan's own gathers and PRNG fold tables, so when the active
    decision IS layerwise the measured Q_W stream matches the executed
    one. `entire_model=False` skips the flat counterfactual compression
    pass (its `em_*` fields stay zero): only GranularitySwitchPolicy and
    telemetry export consume it, and it is the expensive leg (one
    full-model Q_W per step)."""
    leaves, _ = mplan._inputs(grads, key)
    hat = mplan._inputs(grads_hat, key)[0] if grads_hat is not None else None
    flat = mplan._flat(leaves) if mplan.needs_flat else None
    hat_flat = (mplan._flat(hat) if hat is not None and mplan.needs_flat
                else None)
    dev = leaves[0].device
    keys = mplan._keys(key, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    gsum, gsq, qsq, qerr, aerr = [], [], [], [], []
    for b in mplan.buckets:
        x = mplan._gather_runs(leaves, flat, b)
        q = qw.sim(x, mplan._bucket_keys(keys, b))
        gsum.append(torch.sum(x))
        gsq.append(_sumsq(x))
        qsq.append(_sumsq(q))
        qerr.append(_sumsq(q - x))
        del q
        if hat is not None:
            aerr.append(_sumsq(mplan._gather_runs(hat, hat_flat, b) - x))
        else:
            aerr.append(zero)
        del x

    if entire_model:
        # the flat gradient as ONE unit, with the legacy entire_model key
        # derivation (fold_in(key, 0))
        em = (flat if flat is not None else mplan._flat(leaves))
        q_em = qw.sim(em, fold_in(key.to(dev), 0)[None])
        em_sumsq, em_qw_sumsq = _sumsq(em), _sumsq(q_em)
        em_errsq = _sumsq(q_em - em)
        del q_em, em
    else:
        em_sumsq = em_qw_sumsq = em_errsq = zero
    return TelemetryState(
        steps=torch.ones((), dtype=torch.float32, device=dev),
        grad_sum=torch.stack(gsum), grad_sumsq=torch.stack(gsq),
        qw_sumsq=torch.stack(qsq), qw_errsq=torch.stack(qerr),
        agg_errsq=torch.stack(aerr), em_sumsq=em_sumsq,
        em_qw_sumsq=em_qw_sumsq, em_errsq=em_errsq)


def _codec_or_none(qw: Compressor):
    from repro_torch.core.wire import wire_codec
    try:
        return wire_codec(qw)
    except ValueError:
        return None


def payload_bits_per_step(mplan: UnitPlan, qw: Compressor,
                          measured: bool = True) -> int:
    """Static uplink payload bits per step, summed bucket by bucket
    (n_units x per-unit payload): a different summation order than
    bits.comm_report's per-unit walk, and the tests hold the two equal.
    `measured=True` charges each bucket the real packed wire size of its
    codec (8 x payload bytes), falling back to the analytic accounting
    for compressors without a codec; `measured=False` keeps the pure
    accounting."""
    codec = _codec_or_none(qw) if measured else None
    total = 0
    for b in mplan.buckets:
        total += b.n * (codec.wire_bits(b.dim) if codec is not None
                        else qw.payload_bits(b.dim))
    return total


def _host(state: TelemetryState):
    """The state's fields as Python floats / lists, in one copy each."""
    return TelemetryState(*(v.detach().to("cpu").tolist() for v in state))


def summarize(state: TelemetryState, mplan: UnitPlan,
              qw: Optional[Compressor] = None) -> Dict:
    """Host-side window summary: plain Python floats, JSON-exportable.

    Per bucket: mean-per-step gradient energy, entry variance, empirical
    Omega_hat (= E|Q(x)|^2 / |x|^2 - 1), relative compression error,
    end-to-end relative aggregation error, and (when `qw` is given) the
    static payload bits the active compressor puts on the wire per step.
    """
    h = _host(state)
    steps = float(h.steps)
    out: Dict = {"steps": steps, "buckets": [], "entire_model": {}}
    if steps == 0:
        return out
    gsum, gsq, qsq = h.grad_sum, h.grad_sumsq, h.qw_sumsq
    qerr, aerr = h.qw_errsq, h.agg_errsq
    codec = _codec_or_none(qw) if qw is not None else None
    total_payload = 0
    total_wire = 0
    for i, b in enumerate(mplan.buckets):
        n_elems = steps * b.n * b.dim
        mean = gsum[i] / n_elems
        var = max(0.0, gsq[i] / n_elems - mean * mean)
        entry = {
            "dim": b.dim,
            "n_units": b.n,
            "grad_norm_sq": gsq[i] / steps,
            "grad_var": var,
            "omega_hat": qsq[i] / (gsq[i] + _EPS) - 1.0,
            "rel_err": qerr[i] / (gsq[i] + _EPS),
            "agg_rel_err": aerr[i] / (gsq[i] + _EPS),
        }
        if qw is not None:
            entry["payload_bits"] = b.n * qw.payload_bits(b.dim)
            total_payload += entry["payload_bits"]
            if codec is not None:
                # measured leg: the real packed bytes x 8 (accounted +
                # word-padding slack)
                entry["wire_bits"] = b.n * codec.wire_bits(b.dim)
                total_wire += entry["wire_bits"]
        out["buckets"].append(entry)
    if qw is not None:
        out["payload_bits_per_step"] = total_payload
        if codec is not None:
            out["wire_bits_per_step"] = total_wire
    em_sq = float(h.em_sumsq)
    if em_sq > 0.0:  # counterfactual leg was measured (entire_model=True)
        out["entire_model"] = {
            "dim": mplan.total,
            "grad_norm_sq": em_sq / steps,
            "omega_hat": float(h.em_qw_sumsq) / (em_sq + _EPS) - 1.0,
            "rel_err": float(h.em_errsq) / (em_sq + _EPS),
        }
    return out


def unit_omegas(summary: Dict, mplan: UnitPlan,
                metric: str = "rel_err") -> List[float]:
    """Expand a window summary's per-bucket statistic to one value per
    accounting unit, in the plan's unit order (feeds the measured-omega
    form of theory.noise_bounds_from_plan)."""
    per_unit = [0.0] * mplan.num_exec_units
    for entry, b in zip(summary["buckets"], mplan.buckets):
        for uid in b.unit_ids:
            per_unit[uid] = float(entry[metric])
    return per_unit


def to_json(payload: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
