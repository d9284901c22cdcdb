"""The port's observability package (repro_torch/obs: the trace recorder,
the metrics registry, alpha-beta calibration) and its hooks through plan,
schedule, wire, the Engine, the controller and both CLIs, against the JAX
package's obs/ on the CPU (tests/test_obs.py's properties, each held
against the reference).

Inputs are made with numpy from a seed (tests/test_obs.py's `_tree`
shapes) and handed to both packages. Times are never compared: the
structure is. Each event's `args` (message, bucket_ids, n_units, dims,
codec, the stage sets, step, schema_version) equals the reference
recorder's on the simulated path, the wire path, the bare-plan dispatch
path, over several steps and over 3 compressors x 3 fusion thresholds.
The port encodes a step's buckets in one grouped launch and decodes them
in one, so its wire path has fewer stage spans than the reference's
(one compress and one decode interval shared by every message,
obs.trace.mark_group): the message spans, their attribution and their
stage sets are the reference's.

The module's fixture starts, together:
  - the reference's cases in a subprocess on one XLA thread (the jax-0.9
    shim and threefry_partitionable(False) of test_torch_ref.reference,
    every traced function jitted): each case's event args, its
    count_debug_callbacks, the controller's counters, fit_alpha_beta on
    the module's samples and the reference's reading of the port's
    exported trace and metrics lines (which the fixture writes first);
    and in a second subprocess the quickstart's lines, calibrate("tiny",
    reps=1), the Engine's gauges (mamba2 smoke, one device) and the
    streams' message layouts;
  - the reference's train CLI with --trace-out / --metrics-out at
    --data 1 in a third subprocess (one XLA thread);
  - one run_ranks spawn of 2 gloo CPU ranks: rank 0 runs the Engine on a
    one-rank group with tracer= and metrics=; both ranks run
    measure_stream (ring, rs) and measure_collective, then the train
    CLI's rank loop with both flags (2 ranks);
and the in-process cases run beside them. The zero-overhead contract is
held on op sequences (a TorchDispatchMode log): no recorder, None and a
disabled recorder run the same ops and give bitwise equal outputs and
buffers.

This module imports no jax at module level: the spawned ranks import it.
"""
import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 2
RANK_TIMEOUT = 300.0
REF_TIMEOUT = 600.0
ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")
SWEEP = [(c, kw, fb) for c, kw in (("qsgd", {"levels": 16}),
                                   ("terngrad", {}), ("signsgd", {}))
         for fb in (0.0, 4096.0, math.inf)]
# fit_alpha_beta's inputs: an exact line, a noisy line, a flat line, one
# size, NaN, inf, empty, and a negative slope
FIT_SAMPLES = {
    "line": [(b, 100.0 + b / (10.0 * 1e3)) for b in (1e3, 1e4, 1e5, 1e6)],
    "noisy": [(4096.0, 61.5), (65536.0, 97.25), (1048576.0, 402.0),
              (8192.0, 55.0), (131072.0, 120.125)],
    "flat": [(1e3, 50.0), (1e6, 50.0)],
    "one_size": [(2048.0, 10.0), (2048.0, 12.0), (2048.0, 11.0)],
    "nan": [(1e3, float("nan")), (1e4, 20.0)],
    "inf": [(float("inf"), 3.0), (1e4, 20.0)],
    "empty": [],
    "negative": [(1e3, 90.0), (1e4, 80.0), (1e5, 70.0)],
}
# the metrics call script both registries are fed
METRIC_CALLS = [("inc", "train/steps", 1.0), ("inc", "train/steps", 2.0),
                ("gauge", "engine/n_messages", 7.0)] + [
    ("observe", "serve/decode_us", v) for v in (1.0, 5.0, 3.0, 9.0, 7.0)]
SUMMARIES = [
    {"step": 0, "n_spans": 12, "n_message_spans": 4,
     "stage_us": {"compress": 7799.016, "decode": 2951.358, "pack": 570.6},
     "wall_us": 11320.982},
    {"step": 3, "n_spans": 0, "n_message_spans": 0, "stage_us": {},
     "wall_us": 0.0}]
# the train CLI: llama3 smoke, QSGD(16) layerwise over the wire, 2 steps
TRAIN_CLI = ["--arch", "llama3-405b", "--smoke", "--steps", "2",
             "--compressor", "qsgd", "--granularity", "layerwise", "--wire",
             "--batch", "8", "--seq", "16"]
STREAM_CASES = [("ring", 0.0, None), ("ring", 4096.0, 64.0),
                ("rs", 0.0, None), ("rs", 4096.0, 64.0)]
SERVE_GEN = 4


# ---- inputs ---------------------------------------------------------------------

def _tree_np(seed=0):
    """tests/test_obs.py's `_tree` shapes: a stacked (3, 16, 8) block and
    its (3, 8) bias, three loose leaves of other sizes and a scalar."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return np.asarray(rng.standard_normal(shape), np.float32)
    return {"blocks": {"w": draw(3, 16, 8), "b": draw(3, 8)},
            "embed": draw(20, 4), "head": draw(4, 2),
            "scalar_gain": draw()}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _args(events) -> list:
    """The events' args without times, sorted by (stage, message, label):
    what must equal the reference's. A message span's `stages` are the
    stage set; the port's wire path marks fewer stage spans (one grouped
    interval), so stage spans are compared as message -> stage sets."""
    return sorted((json.loads(json.dumps(e["args"])) for e in events),
                  key=lambda a: (a["stage"], a.get("message", -1),
                                 a.get("bucket_ids", [])))


def _stage_sets(rec, step=0) -> dict:
    out = {}
    for e in rec.span_events(cat="stage", step=step):
        a = e["args"]
        out.setdefault(str(a["message"]), set()).add(
            (a["stage"], a["codec"]))
    return {k: sorted(v) for k, v in out.items()}


def _metrics_lines(reg_cls):
    reg = reg_cls()
    for op, name, v in METRIC_CALLS:
        getattr(reg, op)(name, v)
    return reg


# ---- the reference (subprocess A) ---------------------------------------------------

def _ref_case(ref, sched, fn, tree, key, wire=None, steps=1):
    """One jitted reference run of sched.execute under a recorder ->
    (recorder, summaries)."""
    import jax
    rec = ref.obs.TraceRecorder()
    if wire is not None:
        f = jax.jit(lambda t, k: sched.execute(None, t, k, wire=wire,
                                               recorder=rec))
    else:
        f = jax.jit(lambda t, k: sched.execute(fn, t, k, recorder=rec))
    sums = []
    for i in range(steps):
        jax.block_until_ready(f(tree, key))
        sums.append(rec.finalize_step(i))
    return rec, sums


def _emit(out: pathlib.Path, name: str, obj) -> None:
    """One reference result as ref_<name>.json, written atomically (the
    tests poll for it)."""
    tmp = out / f"ref_{name}.tmp"
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, out / f"ref_{name}.json")


def reference_main(out_dir: str) -> None:
    """Every reference-side result of the module, each in its own file as
    soon as it is made, in the order the tests read them."""
    import jax
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    with reference("repro.obs", "repro.control",
                   "repro.core.schedule") as ref:
        obs, core = ref.obs, ref.core
        tree = _jax(_tree_np())
        sm = core.stacked_mask(tree)
        key = jax.random.key(0)
        plan = core.build_plan(tree, sm, core.Granularity("layerwise"))

        def comp(name, **kw):
            return core.make_compressor(name, **kw)

        def sim_fn(c):
            return lambda x, k: c.sim(x, k)
        q16, sg = comp("qsgd", levels=16), comp("signsgd")
        # the span structure cases
        s0 = core.build_schedule(plan, 0.0)
        rec, (summ,) = _ref_case(ref, s0, sim_fn(q16), tree, key)
        _emit(out, "sim", {"args": _args(rec.message_spans(0)),
                           "summary": summ})
        with rec.host_span("compile", note="host side"):
            pass
        rec.export(str(out / "ref_trace.json"))
        rec = obs.TraceRecorder()
        jax.block_until_ready(jax.jit(lambda t, k: plan.execute(
            sim_fn(sg), t, k, recorder=rec))(tree, key))
        rec.finalize_step(0)
        _emit(out, "dispatch", _args(rec.span_events(cat="dispatch",
                                                     step=0)))
        s1k = core.build_schedule(plan, float(1 << 10))
        rec, (summ,) = _ref_case(ref, s1k, None, tree, key,
                                 wire=core.wire_codec(q16))
        _emit(out, "wire", {"args": _args(rec.message_spans(0)),
                            "stages": _stage_sets(rec), "summary": summ})
        rec, sums = _ref_case(ref, core.build_schedule(plan, math.inf),
                              sim_fn(comp("randomk", ratio=0.5)), tree,
                              key, steps=3)
        _emit(out, "multi", {
            "summaries": [[s["step"], s["n_message_spans"]] for s in sums],
            "steps": [s["step"] for s in rec.steps],
            "all": len(rec.message_spans()),
            "step1": len(rec.message_spans(step=1)),
            "args": _args(rec.message_spans()),
            "lines": [obs.format_step_summary(s) for s in SUMMARIES]})
        # the zero-overhead counters
        off = obs.TraceRecorder(enabled=False)
        fn = sim_fn(q16)
        _emit(out, "callbacks", {
            "bare": obs.count_debug_callbacks(
                lambda t, k: s1k.execute(fn, t, k), tree, key),
            "off": obs.count_debug_callbacks(
                lambda t, k: s1k.execute(fn, t, k, recorder=off), tree,
                key),
            "on": obs.count_debug_callbacks(
                lambda t, k: s1k.execute(fn, t, k,
                                         recorder=obs.TraceRecorder()),
                tree, key),
            "wire_off": obs.count_debug_callbacks(
                lambda t, k: s0.execute(None, t, k,
                                        wire=core.wire_codec(sg),
                                        recorder=off), tree, key)})
        # the exports each package reads from the other
        port_trace = json.loads((out / "port_trace.json").read_text())
        try:
            valid = obs.validate_chrome_trace(port_trace)
        except ValueError as e:
            valid = str(e)
        reg = _metrics_lines(obs.MetricsRegistry)
        line = reg.record(step=0)
        reg.export_jsonl(str(out / "ref_metrics.jsonl"))
        reg2 = obs.MetricsRegistry()
        reg2.inc("a")
        reg2.export_jsonl(str(out / "ref_metrics_final.jsonl"))
        _emit(out, "exports", {
            "validates_port_trace": valid, "metrics_line": line,
            "reads_port_metrics": obs.read_jsonl(
                str(out / "port_metrics.jsonl"))})
        _emit(out, "controller", _ref_controller(ref, tree, sm, plan))
        fits = {k: obs.fit_alpha_beta(v) for k, v in FIT_SAMPLES.items()}
        fits["prior"] = obs.fit_alpha_beta(FIT_SAMPLES["one_size"],
                                           prior_alpha_us=7.0,
                                           prior_gbps=3.5)
        _emit(out, "fit", fits)
        # the sweep: a span's args depend on the schedule's messages (and
        # on the wire path the codec), so each distinct (messages, codec)
        # runs once (4096 and inf fuse this 1,988-byte tree into one
        # message alike; the simulated path has no codec attribution)
        runs = {}
        for cname, kw, fb in SWEEP:
            c = comp(cname, **kw)
            sched = core.build_schedule(plan, fb)
            layout = tuple(m.bucket_ids for m in sched.messages)
            if ("sim", layout) not in runs:
                runs["sim", layout] = _ref_case(ref, sched, sim_fn(c), tree,
                                                key)
            if (cname, layout) not in runs:
                runs[cname, layout] = _ref_case(ref, sched, None, tree, key,
                                                wire=core.wire_codec(c))
            rs, _ = runs["sim", layout]
            rw, (sw,) = runs[cname, layout]
            _emit(out, f"sweep_{cname}_{fb}", {
                "sim": _args(rs.message_spans(0)),
                "wire": _args(rw.message_spans(0)),
                "stages": _stage_sets(rw),
                "n_messages": sched.num_messages,
                "wire_message_spans": sw["n_message_spans"]})


def reference_more_main(out_dir: str) -> None:
    """The rest of the reference's results, beside reference_main: the
    quickstart's lines, calibrate("tiny", reps=1), the Engine's gauges and
    the streams' layouts."""
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    mods = ("repro.obs", "repro.control.telemetry", "repro.launch.engine",
            "repro.launch.mesh", "repro.launch.comm_sched",
            "repro.configs.registry")
    with reference(*mods) as ref:
        obs, core = ref.obs, ref.core
        tree = _jax(_tree_np())
        sm = core.stacked_mask(tree)
        q16 = core.make_compressor("qsgd", levels=16)
        _emit(out, "quickstart", _ref_quickstart())
        # the reference's calibrate divides by zero when its fitted gbps
        # rounds to 0.0 (a loaded host's tiny messages; ROADMAP Queue 3
        # item 19): its recorders get a clock that ticks 1 us a stamp, so
        # the counts and keys compared here never hang on the host's load
        C = sys.modules["repro.obs.calibrate"]
        ticks = iter(range(0, 1 << 62, 1000))
        C.TraceRecorder = lambda: obs.TraceRecorder(clock=lambda: next(ticks))
        _emit(out, "calibrate", _calibration_counts(
            obs.calibrate("tiny", tree, sm, q16, reps=1)))
        _emit(out, "engine", _ref_engine(ref))
        _emit(out, "layouts", _ref_layouts(ref, tree, sm, q16))


def _ref_quickstart() -> dict:
    """The printed lines of the reference's examples/quickstart.py
    show_schedule and show_wire."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart", ROOT / "examples" / "quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    return {name: _printed(getattr(qs, name))
            for name in ("show_schedule", "show_wire")}


def _printed(fn, *args) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _calibration_counts(cal) -> dict:
    """A calibrate report without its measured times: its keys, counts,
    bytes and model numbers."""
    ths = {}
    for label, t in cal["thresholds"].items():
        ths[label] = {
            "keys": sorted(t),
            "stage_keys": sorted(t["stage_us_measured"]),
            **{k: t[k] for k in ("fusion_bytes", "n_messages",
                                 "wire_bytes_measured", "wire_bits_model",
                                 "exposed_comm_us_model",
                                 "comm_us_total_model")},
            "per_message": [[m["message"], m["wire_bytes"]]
                            for m in t["per_message_measured"]]}
    fit = next(iter(cal["fit_by_host"].values()))
    return {"keys": sorted(cal), "config": cal["config"],
            "codec": cal["codec"], "granularity": cal["granularity"],
            "model_defaults": cal["model_defaults"],
            "hosts": sorted(cal["fit_by_host"]), "fit_keys": sorted(fit),
            "n_samples": fit["n_samples"], "thresholds": ths}


class _Flip:
    """A duck-typed policy that switches between two decisions at every
    re-plan (either package's Controller takes it)."""
    name = "flip"
    needs_telemetry = False

    def __init__(self, a, b):
        self.a, self.b = a, b

    def decide(self, summary, decision, mplan):
        return self.b if decision == self.a else self.a


def _controller_cases(Controller, StaticPolicy, Decision, MetricsRegistry,
                      qw, gran, plan, build) -> dict:
    """tests/test_obs.py's watchdog cases (silent on healthy revisits,
    fires on an evicted cache) and a re-plan window with switches, on
    either package's controller -> builds, counts, counters, gauges."""
    base = Decision(qw=qw, granularity=gran("layerwise"))
    alt = Decision(qw=qw, granularity=gran("entire_model"))

    def tiny(metrics, policy=None, replan_every=20):
        return Controller(policy or StaticPolicy(), build, base, plan,
                          collect_telemetry=False, metrics=metrics,
                          replan_every=replan_every)
    out = {}
    reg = MetricsRegistry()
    ctrl = tiny(reg)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        f_base = ctrl.step_fn()
        ctrl.set_decision(alt)
        f_alt = ctrl.step_fn()
        ctrl.set_decision(base)
        hit = ctrl.step_fn() is f_base
        ctrl.set_decision(alt)
        hit = hit and ctrl.step_fn() is f_alt
    out["healthy"] = {"builds": ctrl.builds, "hits": hit,
                      "unexpected": ctrl.check_retraces(),
                      "counters": dict(reg.counters),
                      "gauges": dict(reg.gauges)}
    reg = MetricsRegistry()
    ctrl = tiny(reg)
    ctrl.step_fn()
    ctrl._cache.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ctrl.step_fn()
    out["evicted"] = {"builds": ctrl.builds,
                      "unexpected": ctrl.check_retraces(),
                      "warned": [str(x.message) for x in w],
                      "counters": dict(reg.counters),
                      "gauges": dict(reg.gauges)}
    reg = MetricsRegistry()
    ctrl = tiny(reg, _Flip(base, alt), replan_every=2)
    changed = []
    for i in range(5):
        ctrl.step_fn()
        changed.append(ctrl.observe(None, i))
    ctrl.check_retraces()
    rep = ctrl.report()
    out["replans"] = {"changed": changed, "builds": ctrl.builds,
                      "switches": len(ctrl.switches),
                      "counters": dict(reg.counters),
                      "gauges": dict(reg.gauges),
                      "report_keys": sorted(rep),
                      "active_keys": sorted(rep["active"])}
    return out


def _ref_controller(ref, tree, sm, plan) -> dict:
    import jax
    c, core, obs = ref.control, ref.core, ref.obs
    return _controller_cases(
        c.Controller, c.StaticPolicy, c.CompressionDecision,
        obs.MetricsRegistry, core.make_compressor("randomk", ratio=0.5),
        core.Granularity, plan, lambda d: jax.jit(lambda x: x + 1))


def _ref_engine(ref) -> dict:
    """The reference Engine's build-time counters and gauges (mamba2
    smoke, one device, QSGD(16) layerwise, the per-bucket schedule, the
    wire and simulated steps): built, not run."""
    import sys as _sys
    E = _sys.modules["repro.launch.engine"]
    M = _sys.modules["repro.launch.mesh"]
    CS = _sys.modules["repro.launch.comm_sched"]
    core, obs = ref.core, ref.obs
    cfg = ref.registry.get_smoke("mamba2-1.3b")
    comp = core.CompressionConfig(qw=core.make_compressor("qsgd", levels=16),
                                  granularity=core.Granularity("layerwise"))
    eng = E.Engine(cfg, M.make_host_mesh(1, 1), comp=comp)
    sched = CS.engine_schedule(eng, 0.0)
    reg = obs.MetricsRegistry()
    eng.build_train_step(schedule=sched, tracer=obs.TraceRecorder(),
                         metrics=reg)
    plain = obs.MetricsRegistry()
    eng.build_train_step(metrics=plain)
    rest = eng.comm_plans(comp)[0]
    return {"counters": reg.counters, "gauges": reg.gauges,
            "plain": {"counters": plain.counters, "gauges": plain.gauges},
            "n_messages": sched.num_messages,
            "n_dispatches": rest.num_dispatches,
            "payload_bits": ref.telemetry.payload_bits_per_step(rest,
                                                                comp.qw)}


def _ref_layouts(ref, tree, sm, q16) -> dict:
    """Each stream case's message bytes, chunks and hop bytes on RANKS
    workers from the reference's layouts."""
    core = ref.core
    W = sys.modules["repro.core.wire"]
    plan = core.build_plan(tree, sm, core.Granularity("layerwise"))
    codec = core.wire_codec(q16)
    out = {}
    for mode, fb, chunk in STREAM_CASES:
        sched = core.build_schedule(plan, fb)
        lays = (W.message_layouts(sched, codec) if mode == "ring"
                else W.shard_message_layouts(sched, codec, RANKS))
        out[f"{mode}/{fb}/{chunk}"] = {
            "n_messages": sched.num_messages,
            "n_hops": sched.num_messages * (RANKS - 1),
            "wire_bytes": sum(l.total_nbytes for l in lays),
            "per_message": [[mi, l.total_nbytes,
                             len(W.layout_chunks(l, chunk)),
                             (RANKS - 1) * l.total_nbytes]
                            for mi, l in enumerate(lays)]}
    lays = W.message_layouts(core.build_schedule(plan, 0.0), codec)
    out["collective"] = {"wire_bytes": sum(l.total_nbytes for l in lays),
                         "n_messages": len(lays)}
    return out


def reference_train_main(out_dir: str) -> None:
    """The reference's train CLI with both flags at --data 1."""
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    with reference("repro.launch.train", "repro.obs"):
        T = sys.modules["repro.launch.train"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            T.main(TRAIN_CLI + ["--data", "1", "--trace-out",
                                str(out / "ref_train_trace.json"),
                                "--metrics-out",
                                str(out / "ref_train_metrics.jsonl")])
    (out / "ref_train_lines.txt").write_text(buf.getvalue())


# ---- the port's ranks ----------------------------------------------------------------

def _host(tree) -> dict:
    from repro_torch.convert import tree_leaves, tree_paths
    return {"/".join(p): l.detach().numpy().copy()
            for p, l in zip(tree_paths(tree), tree_leaves(tree))}


def rank_main(rank, world, dev, out_dir):
    """Rank 0: the Engine cases on a one-rank group; both ranks: the
    streams and the allgather collective, then the train CLI's rank loop
    with both flags (rank 0 exports)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    solo = dist.new_group([0])
    out = {}
    if rank == 0:
        out["engine"] = _engine_cases(
            Mesh(("data", "model"), (1, 1), {"data": solo}), dev)
    dist.barrier()
    out["streams"] = _stream_cases(dev)
    dist.barrier()
    args = train._parse(TRAIN_CLI + [
        "--data", str(world), "--device", "cpu", "--backend", "gloo",
        "--trace-out", str(pathlib.Path(out_dir) / "port_train_trace.json"),
        "--metrics-out",
        str(pathlib.Path(out_dir) / "port_train_metrics.jsonl")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli"] = train._train_rank(rank, world, dev, args, False)
    out["lines"] = buf.getvalue().splitlines()
    return out


def _engine_cases(mesh, dev) -> dict:
    """The Engine (mamba2 smoke, QSGD(16) layerwise, the per-bucket
    schedule) with tracer= and metrics=: 2 traced steps, simulated and
    wire; the same steps untraced and with a disabled tracer."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import (CompressionConfig, Granularity,
                                  make_compressor)
    from repro_torch.launch.comm_sched import engine_schedule
    from repro_torch.launch.engine import Engine
    from repro_torch.obs import (MetricsRegistry, TraceRecorder,
                                 validate_chrome_trace)
    cfg = get_smoke("mamba2-1.3b")
    comp = CompressionConfig(qw=make_compressor("qsgd", levels=16),
                             granularity=Granularity("layerwise"))
    eng = Engine(cfg, mesh, comp=comp, device=dev)
    sched = engine_schedule(eng, 0.0)
    batch = {"tokens": torch.full((4, 16), 3, dtype=torch.int32),
             "targets": torch.full((4, 16), 5, dtype=torch.int32)}
    out = {"n_messages": sched.num_messages}
    for wire in (False, True):
        rec, reg = TraceRecorder(), MetricsRegistry()
        fn = eng.build_train_step(schedule=sched, wire=wire, tracer=rec,
                                  metrics=reg)
        params, opt = eng.init_state(0)
        spans, sums = [], []
        for i in range(2):
            params, opt, m = fn(params, opt, batch, i)
            sums.append(rec.finalize_step(i))
            spans.append(len(rec.message_spans(step=i)))
        validate_chrome_trace(rec.chrome_trace())
        runs = {"traced": _host(params)}
        for tag, tracer in (("bare", None),
                            ("off", TraceRecorder(enabled=False))):
            f = (eng.build_train_step(schedule=sched, wire=wire)
                 if tag == "bare" else
                 eng.build_train_step(schedule=sched, wire=wire,
                                      tracer=tracer))
            p, o = eng.init_state(0)
            for i in range(2):
                p, o, _ = f(p, o, batch, i)
            runs[tag] = _host(p)
        out["wire" if wire else "sim"] = {
            "spans": spans, "summaries": sums, "runs": runs,
            "stages": _stage_sets(rec, 1),
            "args": _args(rec.message_spans(step=1)),
            "counters": reg.counters, "gauges": reg.gauges}
    plain = MetricsRegistry()
    eng.build_train_step(metrics=plain)
    out["plain"] = {"counters": plain.counters, "gauges": plain.gauges}
    return out


def _stream_cases(dev) -> dict:
    from repro_torch.core import make_compressor, stacked_mask
    from repro_torch.obs.calibrate import measure_collective, measure_stream
    t = _torch(_tree_np())
    sm = stacked_mask(t)
    q16 = make_compressor("qsgd", levels=16)
    out = {}
    for mode, fb, chunk in STREAM_CASES:
        out[f"{mode}/{fb}/{chunk}"] = measure_stream(
            t, sm, q16, fb, mode=mode, chunk_bytes=chunk, reps=2, warmup=1)
    out["collective"] = measure_collective(t, sm, q16, 0.0, reps=2,
                                           warmup=1)
    return out


# ---- the module fixture ----------------------------------------------------------------

class _Run:
    """The module's runs, started together by the fixture; each test waits
    for the file or run it reads (so no test waits for them all)."""

    def __init__(self, out, procs, spawn):
        self.out, self.procs, self.spawn = out, procs, spawn
        self._ref = {}

    def _proc(self, name):
        proc = self.procs[name]
        log, _ = proc.communicate(timeout=REF_TIMEOUT)
        assert proc.returncode == 0, log[-4000:]

    def ref(self, name: str):
        """The reference's result `name`, once its file is there."""
        if name not in self._ref:
            path = self.out / f"ref_{name}.json"
            deadline = time.monotonic() + REF_TIMEOUT
            while not path.exists():
                for proc in self.procs:
                    if self.procs[proc].poll() not in (None, 0):
                        self._proc(proc)
                assert time.monotonic() < deadline, f"no {path.name}"
                time.sleep(0.05)
            self._ref[name] = json.loads(path.read_text())
        return self._ref[name]

    def ref_train(self) -> pathlib.Path:
        self._proc("train")
        return self.out

    def ranks(self):
        th, box = self.spawn
        th.join(RANK_TIMEOUT)
        assert not th.is_alive(), "the rank spawn did not finish"
        if "error" in box:
            raise box["error"]
        return box["ranks"]


def _port_exports(out: pathlib.Path) -> None:
    """The port's trace (the simulated per-bucket QSGD(16) step and a host
    span) and metrics lines, for the reference to read."""
    from repro_torch import random as R
    from repro_torch.core import (Granularity, build_plan, build_schedule,
                                  make_compressor, stacked_mask)
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    t = _torch(_tree_np())
    q16 = make_compressor("qsgd", levels=16)
    sched = build_schedule(build_plan(t, stacked_mask(t),
                                      Granularity("layerwise")), 0.0)
    rec = TraceRecorder()
    sched.execute(lambda x, k: q16.sim(x, k), t, R.key(0), recorder=rec)
    rec.finalize_step(0)
    with rec.host_span("compile", note="host side"):
        pass
    rec.export(str(out / "port_trace.json"))
    reg = _metrics_lines(MetricsRegistry)
    reg.record(step=0)
    reg.export_jsonl(str(out / "port_metrics.jsonl"))


@pytest.fixture(scope="module", autouse=True)
def obs_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs")
    _port_exports(out)
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env = dict(os.environ, XLA_FLAGS=ONE_THREAD, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", f"import sys, test_torch_obs as t; "
         f"t.{main}(sys.argv[1])", str(out)], env=env,
        cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, main in (("ref", "reference_main"),
                           ("more", "reference_more_main"),
                           ("train", "reference_train_main"))}
    # import in this thread: two threads importing the package at once
    # can each see the other's half-initialized modules
    from repro_torch.launch import train  # noqa: F401
    from repro_torch.launch.mesh import run_ranks
    import repro_torch.obs  # noqa: F401
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(rank_main, RANKS, backend="gloo",
                                     device="cpu", args=(str(out),),
                                     timeout=RANK_TIMEOUT)
        except BaseException as e:     # re-raised by the test that reads it
            box["error"] = e
    th = threading.Thread(target=spawn, daemon=True)
    th.start()
    yield _Run(out, procs, (th, box))
    th.join(RANK_TIMEOUT)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---- in-process helpers -------------------------------------------------------

def _port_inputs():
    from repro_torch.core import (Granularity, build_plan, make_compressor,
                                  stacked_mask)
    t = _torch(_tree_np())
    sm = stacked_mask(t)
    return t, sm, build_plan(t, sm, Granularity("layerwise")), \
        make_compressor


def _bitwise(a, b, ctx):
    """Two trees (or sequences) of tensors: same shapes, dtypes, bytes."""
    from repro_torch.convert import tree_leaves
    la = tree_leaves(a) if isinstance(a, dict) else list(a)
    lb = tree_leaves(b) if isinstance(b, dict) else list(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, ctx
        assert torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                           y.contiguous().reshape(-1).view(torch.uint8)), ctx


def _norm(stages: dict) -> dict:
    """Stage sets as JSON gives them back (lists, not tuples)."""
    return {k: [list(x) for x in v] for k, v in stages.items()}


class _Ops:
    """The aten ops a call runs, in order (a TorchDispatchMode log)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __init__(mode):
                super().__init__()
                mode.ops = []

            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                mode.ops.append(str(func))
                return func(*args, **(kwargs or {}))
        self.mode = Mode

    def __call__(self, fn, *args):
        with self.mode() as m:
            out = fn(*args)
        return out, m.ops


def _run_sim(sched, c, t, rec, key=None):
    from repro_torch import random as R
    return sched.execute(lambda x, k: c.sim(x, k), t,
                         R.key(0) if key is None else key, recorder=rec)


def _run_wire(sched, c, t, rec):
    from repro_torch import random as R
    from repro_torch.core import wire_codec
    from repro_torch.core.wire import execute_schedule_wire
    return execute_schedule_wire(sched, wire_codec(c), t, R.key(0),
                                 recorder=rec)


# ---- port-only: names, registries, clocks and the CLIs' outputs ----------------

def test_obs_package_names():
    import ast
    import repro_torch.obs as port
    src = (ROOT / "src" / "repro" / "obs" / "__init__.py").read_text()
    want = next(ast.literal_eval(n.value) for n in ast.parse(src).body
                if isinstance(n, ast.Assign)
                and n.targets[0].id == "__all__")
    assert port.__all__ == want
    assert all(hasattr(port, n) for n in want)


def test_disabled_metrics_noop():
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry(enabled=False)
    reg.inc("a")
    reg.gauge("b", 1.0)
    reg.observe("c", 2.0)
    reg.record(step=0)
    assert reg.counters == {} and reg.gauges == {} and reg.histograms == {}
    snap = reg.snapshot()
    assert snap["counters"] == {} and snap["kind"] == "snapshot"


def test_recorder_refuses_mixed_clocks():
    """A recorder that took a host stamp refuses a CUDA-device one (and
    the reverse) rather than mixing two clocks in one timeline."""
    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    rec.mark(torch.zeros(1), "x")
    with pytest.raises(ValueError, match="mix two clocks"):
        rec._uses_events(torch.device("cuda"))
    rec.finalize_step(0)
    assert len(rec.span_events()) == 1


def test_zero_overhead_plan_with_state():
    """plan.execute_with_state (the EF memory path): a disabled recorder
    runs the bare ops, an enabled one marks a dispatch span a bucket and
    changes no numerics."""
    from repro_torch import random as R
    from repro_torch.obs import TraceRecorder
    t, _, plan, mk = _port_inputs()
    q = mk("terngrad")
    fn = lambda x, m, k: (q.sim(x + m, k), x - q.sim(x + m, k))  # noqa
    m0 = {k: v for k, v in t.items()}
    ops = _Ops()
    base, base_ops = ops(lambda: plan.execute_with_state(fn, t, m0,
                                                         R.key(1)))
    got, seq = ops(lambda: plan.execute_with_state(
        fn, t, m0, R.key(1), recorder=TraceRecorder(enabled=False)))
    assert seq == base_ops
    _bitwise(got[0], base[0], "state-disabled")
    rec = TraceRecorder()
    got = plan.execute_with_state(fn, t, m0, R.key(1), recorder=rec)
    s = rec.finalize_step(0)
    assert s["n_spans"] == plan.num_dispatches
    _bitwise(got[0], base[0], "state-recorded")
    _bitwise(got[1], base[1], "state-recorded-m")


def test_engine_controller_threads_tracer_and_metrics():
    """engine_controller passes tracer= and metrics= to every step it
    builds (the cache tag carries the tracer) and counts its builds."""
    from repro_torch.configs import get_smoke
    from repro_torch.control import StaticPolicy, engine_controller
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    from repro_torch.core import (CompressionConfig, Granularity,
                                  make_compressor)
    comp = CompressionConfig(qw=make_compressor("qsgd", levels=16),
                             granularity=Granularity("layerwise"))
    eng = Engine(get_smoke("llama3-405b"), make_host_mesh(data=1),
                 comp=comp, device="cpu")
    rec, reg = TraceRecorder(), MetricsRegistry()
    ctrl = engine_controller(eng, StaticPolicy(), metrics=reg, tracer=rec)
    step = ctrl.step_fn()
    assert step.tracer is rec
    assert reg.counters == {"controller/builds": 1.0,
                            "engine/step_builds": 1.0}
    assert reg.gauges["engine/n_dispatches"] == \
        eng.comm_plans(comp)[0].num_dispatches
    assert ctrl._cache_tag[-1] is rec


def test_serve_cli_trace_and_metrics(tmp_path):
    """serve --trace-out / --metrics-out on the CPU: one prefill span and
    gen - 1 decode spans, serve/decode_us with gen - 1 samples, the
    reference's counter, gauge and label names, a valid trace; the
    continuation is the untraced run's."""
    from repro_torch.launch import serve
    from repro_torch.obs import read_jsonl, validate_chrome_trace
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt", "8", "--gen", str(SERVE_GEN)]
    plain, traced = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(plain):
        serve.main(base)
    with contextlib.redirect_stdout(traced):
        serve.main(base + ["--trace-out", str(trace), "--metrics-out",
                           str(metrics)])
    cont = [l for l in plain.getvalue().splitlines()
            if l.startswith("sample continuation")]
    lines = traced.getvalue().splitlines()
    assert [l for l in lines if l.startswith("sample continuation")] == cont
    assert lines[-2].startswith(f"trace -> {trace} (")
    assert lines[-1] == f"metrics -> {metrics} (1 lines)"
    obj = json.loads(trace.read_text())
    validate_chrome_trace(obj)
    names = [e["name"] for e in obj["traceEvents"] if e["ph"] == "X"]
    assert names == ["prefill"] + ["decode"] * (SERVE_GEN - 1)
    (line,) = read_jsonl(str(metrics))
    assert line["counters"] == {"serve/requests": 1.0,
                                "serve/tokens": 2.0 * (SERVE_GEN - 1)}
    assert sorted(line["gauges"]) == ["serve/prefill_us"]
    assert line["histograms"]["serve/decode_us"]["count"] == SERVE_GEN - 1
    assert line["labels"] == {"arch": "phi4-smoke", "batch": 2}


# ---- span structure == the reference's --------------------------------------------

def test_message_spans_match_reference(obs_run):
    """Per-bucket threshold, simulated path: one message span per
    schedule message, bucket attribution == plan.readiness_order(), and
    every span's args the reference's."""
    from repro_torch.core import build_schedule
    from repro_torch.obs import TRACE_SCHEMA_VERSION, TraceRecorder
    t, _, plan, mk = _port_inputs()
    sched = build_schedule(plan, 0.0)
    rec = TraceRecorder()
    _run_sim(sched, mk("qsgd", levels=16), t, rec)
    summary = rec.finalize_step(0)
    spans = rec.message_spans(step=0)
    assert len(spans) == sched.num_messages == summary["n_message_spans"]
    ordered = sorted(spans, key=lambda e: e["args"]["message"])
    assert tuple(b for e in ordered for b in e["args"]["bucket_ids"]) == \
        plan.readiness_order()
    for e in ordered:
        assert e["args"]["schema_version"] == TRACE_SCHEMA_VERSION
    ref = obs_run.ref("sim")
    assert _args(spans) == ref["args"]
    assert summary["n_spans"] == ref["summary"]["n_spans"]
    assert sorted(summary["stage_us"]) == sorted(ref["summary"]["stage_us"])


def test_plan_dispatch_spans_match_reference(obs_run):
    """Bare UnitPlan execution: one dispatch span per bucket, the
    reference's args."""
    from repro_torch import random as R
    from repro_torch.obs import TraceRecorder
    t, _, plan, mk = _port_inputs()
    sg = mk("signsgd")
    rec = TraceRecorder()
    plan.execute(lambda x, k: sg.sim(x, k), t, R.key(0), recorder=rec)
    rec.finalize_step(0)
    spans = rec.span_events(cat="dispatch", step=0)
    assert len(spans) == plan.num_dispatches
    assert sorted(b for e in spans for b in e["args"]["bucket_ids"]) == \
        list(range(plan.num_dispatches))
    assert _args(spans) == obs_run.ref("dispatch")


def test_wire_stage_spans_match_reference(obs_run):
    """Wire path: stage spans carry codec attribution, every message's
    stages include compress / pack / decode, finalize synthesizes exactly
    num_messages umbrella spans, and each message span's args (its stage
    set included) are the reference's. The grouped encode and decode
    give every message one shared interval, counted once in the step's
    totals: the sum of stage_us is at most wall_us."""
    from repro_torch.core import build_schedule, wire_codec
    from repro_torch.obs import TraceRecorder
    t, _, plan, mk = _port_inputs()
    sched = build_schedule(plan, float(1 << 10))
    q16 = mk("qsgd", levels=16)
    rec = TraceRecorder()
    _run_wire(sched, q16, t, rec)
    summary = rec.finalize_step(0)
    msgs = rec.message_spans(step=0)
    assert len(msgs) == sched.num_messages == summary["n_message_spans"]
    stages = _stage_sets(rec)
    assert sorted(stages) == [str(i) for i in range(sched.num_messages)]
    for st in stages.values():
        assert {"compress", "pack", "decode"} <= {s for s, _ in st}
        assert {c for _, c in st} == {wire_codec(q16).name}
    ref = obs_run.ref("wire")
    assert _args(msgs) == ref["args"]
    assert _norm(stages) == ref["stages"]
    # shared intervals: compress / decode spans of one step coincide
    for stage in ("compress", "decode"):
        ivs = {(e["ts"], e["dur"]) for e in rec.span_events(cat="stage")
               if e["args"]["stage"] == stage}
        assert len(ivs) == 1, (stage, ivs)
    assert round(sum(v * 1000 for v in summary["stage_us"].values())) <= \
        round(summary["wall_us"] * 1000)


def test_multi_step_and_summary_format(obs_run):
    from repro_torch import random as R
    from repro_torch.core import build_schedule
    from repro_torch.obs import TraceRecorder, format_step_summary
    t, _, plan, mk = _port_inputs()
    rk = mk("randomk", ratio=0.5)
    sched = build_schedule(plan, math.inf)
    rec = TraceRecorder()
    sums = []
    for i in range(3):
        _run_sim(sched, rk, t, rec, R.key(0))
        s = rec.finalize_step(i)
        sums.append([s["step"], s["n_message_spans"]])
        assert "message spans" in format_step_summary(s)
    ref = obs_run.ref("multi")
    assert sums == ref["summaries"] == [[0, 1], [1, 1], [2, 1]]
    assert [s["step"] for s in rec.steps] == ref["steps"]
    assert len(rec.message_spans()) == ref["all"] == 3
    assert len(rec.message_spans(step=1)) == ref["step1"] == 1
    assert _args(rec.message_spans()) == ref["args"]
    assert [format_step_summary(s) for s in SUMMARIES] == ref["lines"]


# ---- the zero-overhead contract ------------------------------------------------

def test_zero_overhead_when_disabled(obs_run):
    """recorder=None, a disabled recorder and no recorder at all run the
    same op sequence with zero marks and bitwise equal outputs; an
    enabled recorder stamps 1 + num_messages marks (the reference's
    count_debug_callbacks) and never changes numerics."""
    from repro_torch import random as R
    from repro_torch.core import build_schedule
    from repro_torch.obs import TraceRecorder, count_debug_callbacks
    t, _, plan, mk = _port_inputs()
    sched = build_schedule(plan, float(1 << 10))
    q16 = mk("qsgd", levels=16)
    fn = lambda x, k: q16.sim(x, k)  # noqa: E731
    off = TraceRecorder(enabled=False)
    bare = lambda: sched.execute(fn, t, R.key(0))  # noqa: E731
    none = lambda: sched.execute(fn, t, R.key(0), recorder=None)  # noqa: E731
    dis = lambda: sched.execute(fn, t, R.key(0), recorder=off)  # noqa: E731
    ops = _Ops()
    ref_out, ref_ops = ops(bare)
    for f in (none, dis):
        out, seq = ops(f)
        assert seq == ref_ops
        _bitwise(out, ref_out, "disabled")
    assert off.events == [] and off.steps == [] and off._marks == []
    cb = obs_run.ref("callbacks")
    assert count_debug_callbacks(bare) == 0 == cb["bare"]
    assert count_debug_callbacks(dis) == 0 == cb["off"]
    rec = TraceRecorder()
    on = lambda: sched.execute(fn, t, R.key(0), recorder=rec)  # noqa: E731
    assert count_debug_callbacks(on) == 1 + sched.num_messages == cb["on"]
    assert rec._marks == []          # counted, not stamped
    got = on()
    rec.finalize_step(0)
    _bitwise(got, ref_out, "recorded-vs-bare")


def test_zero_overhead_wire_path(obs_run):
    from repro_torch.core import build_schedule
    from repro_torch.obs import TraceRecorder, count_debug_callbacks
    t, _, plan, mk = _port_inputs()
    sched = build_schedule(plan, 0.0)
    sg = mk("signsgd")
    off = TraceRecorder(enabled=False)
    ops = _Ops()
    (ref, refb), ref_ops = ops(_run_wire, sched, sg, t, None)
    (got, gotb), seq = ops(_run_wire, sched, sg, t, off)
    assert seq == ref_ops
    _bitwise(got, ref, "wire-disabled")
    _bitwise(gotb, refb, "wire-disabled-buffers")
    assert count_debug_callbacks(_run_wire, sched, sg, t, off) == 0 == \
        obs_run.ref("callbacks")["wire_off"]
    rec = TraceRecorder()
    got, gotb = _run_wire(sched, sg, t, rec)
    rec.finalize_step(0)
    _bitwise(got, ref, "wire-recorded-vs-bare")
    _bitwise(gotb, refb, "wire-buffers")


# ---- exports ------------------------------------------------------------------------

def test_chrome_trace_valid_both_ways(obs_run, tmp_path):
    """The port's trace passes its own validator and the reference's;
    the reference's passes the port's; malformed traces are rejected;
    only metadata.tool names the port's module."""
    from repro_torch.core import build_schedule
    from repro_torch.obs import (TRACE_SCHEMA_VERSION, TraceRecorder,
                                 validate_chrome_trace)
    t, _, plan, mk = _port_inputs()
    rec = TraceRecorder()
    _run_sim(build_schedule(plan, 0.0), mk("qsgd", levels=16), t, rec)
    rec.finalize_step(0)
    with rec.host_span("compile", note="host side"):
        pass
    obj = rec.chrome_trace()
    assert validate_chrome_trace(obj)
    assert obj["metadata"]["schema_version"] == TRACE_SCHEMA_VERSION
    assert obj["metadata"]["steps"] == rec.steps
    assert obj["metadata"]["tool"] == "repro_torch.obs.trace"
    path = tmp_path / "trace.json"
    rec.export(str(path))
    assert validate_chrome_trace(json.loads(path.read_text()))
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "Z", "name": "x",
                                                "pid": 0, "tid": 0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x",
                                                "pid": 0, "tid": 0,
                                                "ts": -1.0, "dur": 0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace([])
    assert obs_run.ref("exports")["validates_port_trace"] is True
    ref_obj = json.loads((obs_run.out / "ref_trace.json").read_text())
    assert validate_chrome_trace(ref_obj)
    # the same event layout: keys of every event, metadata but the tool
    port_obj = json.loads((obs_run.out / "port_trace.json").read_text())

    def layout(obj):
        return sorted((e["name"], sorted(e), sorted(e.get("args", {})))
                      for e in obj["traceEvents"])
    assert layout(port_obj) == layout(ref_obj)
    assert {k: v for k, v in port_obj["metadata"].items()
            if k not in ("tool", "steps")} == {
        k: v for k, v in ref_obj["metadata"].items()
        if k not in ("tool", "steps")}
    assert ref_obj["metadata"]["tool"] == "repro.obs.trace"


def test_metrics_lines_read_both_ways(obs_run, tmp_path):
    """The same calls give the reference's snapshot line, histogram
    summaries included; each package reads the other's export back equal
    to its own registry's line; the final-snapshot fallback."""
    from repro_torch.obs import (METRICS_SCHEMA_VERSION, MetricsRegistry,
                                 read_jsonl)
    reg = _metrics_lines(MetricsRegistry)
    line = reg.record(step=0)
    ref = obs_run.ref("exports")
    assert line == ref["metrics_line"]
    assert line["schema_version"] == METRICS_SCHEMA_VERSION
    h = line["histograms"]["serve/decode_us"]
    assert h["count"] == 5 and h["p50"] == 5.0 and h["sum"] == 25.0
    path = tmp_path / "metrics.jsonl"
    assert reg.export_jsonl(str(path)) == 1
    assert read_jsonl(str(path)) == [line] == [reg.snapshot(step=0)]
    assert path.read_text() == (obs_run.out / "ref_metrics.jsonl").read_text()
    assert read_jsonl(str(obs_run.out / "ref_metrics.jsonl")) == [line]
    assert ref["reads_port_metrics"] == [line]
    reg2 = MetricsRegistry()
    reg2.inc("a")
    assert reg2.export_jsonl(str(path)) == 1
    assert read_jsonl(str(path)) == read_jsonl(
        str(obs_run.out / "ref_metrics_final.jsonl"))
    assert read_jsonl(str(path))[0]["labels"] == {"final": True}


# ---- the controller and calibration ----------------------------------------------

def test_controller_counters_match_reference(obs_run):
    """The retrace watchdog and a re-plan window with switches over the
    same decision sequence as the reference's controller: builds, cache
    hits, the unexpected-retrace count and warning, every counter
    (controller/builds, replans, switches, retraces_unexpected) and gauge
    (retraces_unexpected_total, jit_recompiles = 0)."""
    from repro_torch.control import (CompressionDecision, Controller,
                                     StaticPolicy)
    from repro_torch.core import Granularity
    from repro_torch.obs import MetricsRegistry
    _, _, plan, mk = _port_inputs()
    got = _controller_cases(Controller, StaticPolicy, CompressionDecision,
                            MetricsRegistry, mk("randomk", ratio=0.5),
                            Granularity, plan, lambda d: (lambda x: x + 1))
    assert got == obs_run.ref("controller")
    assert got["healthy"]["hits"] and got["healthy"]["builds"] == 2
    assert "controller/retraces_unexpected" not in \
        got["healthy"]["counters"]
    assert got["evicted"]["counters"]["controller/retraces_unexpected"] \
        == 1.0
    assert got["replans"]["counters"]["controller/switches"] == 2.0
    assert got["replans"]["gauges"]["controller/jit_recompiles"] == 0.0


@pytest.mark.parametrize("name", list(FIT_SAMPLES) + ["prior"])
def test_fit_alpha_beta_matches_reference(obs_run, name):
    """The same samples give the reference's dict bitwise, degenerate
    inputs (one size, NaN, inf, empty, flat) included."""
    from repro_torch.obs import fit_alpha_beta
    want = obs_run.ref("fit")[name]
    if name == "prior":
        got = fit_alpha_beta(FIT_SAMPLES["one_size"], prior_alpha_us=7.0,
                             prior_gbps=3.5)
    else:
        got = fit_alpha_beta(FIT_SAMPLES[name])
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    if name == "line":
        assert abs(got["alpha_us"] - 100.0) < 1.0
        assert abs(got["gbps"] - 10.0) < 0.1


# ---- the sweep ---------------------------------------------------------------------

@pytest.mark.parametrize("case", [f"{c}/{fb}" for c, _, fb in SWEEP])
def test_obs_sweep_matches_reference(obs_run, case):
    """Both execution paths: per-step message spans == num_messages, each
    message span's args (stage sets on the wire path) the reference's,
    recording never changes numerics."""
    from repro_torch.core import build_schedule
    from repro_torch.obs import TraceRecorder
    cname, kw, fb = next(s for s in SWEEP if f"{s[0]}/{s[2]}" == case)
    t, _, plan, mk = _port_inputs()
    c = mk(cname, **kw)
    sched = build_schedule(plan, fb)
    ref = obs_run.ref(f"sweep_{cname}_{fb}")
    assert sched.num_messages == ref["n_messages"]
    rec = TraceRecorder()
    got = _run_sim(sched, c, t, rec)
    assert rec.finalize_step(0)["n_message_spans"] == sched.num_messages
    assert _args(rec.message_spans(0)) == ref["sim"]
    _bitwise(got, _run_sim(sched, c, t, None), (case, "sim"))
    recw = TraceRecorder()
    gotw, bufs = _run_wire(sched, c, t, recw)
    assert recw.finalize_step(0)["n_message_spans"] == sched.num_messages \
        == ref["wire_message_spans"]
    assert _args(recw.message_spans(0)) == ref["wire"]
    assert _norm(_stage_sets(recw)) == ref["stages"]
    refw, refb = _run_wire(sched, c, t, None)
    _bitwise(gotw, refw, (case, "wire"))
    _bitwise(bufs, refb, (case, "buffers"))


def test_calibrate_counts_match_reference(obs_run):
    """calibrate("tiny", reps=1): the reference's keys, message counts,
    buffer bytes, model bits and model times; finite positive ratios;
    JSON-serializable."""
    from repro_torch.obs import calibrate, measure_schedule
    from repro_torch.core import build_schedule
    t, sm, plan, mk = _port_inputs()
    q16 = mk("qsgd", levels=16)
    meas = measure_schedule(t, sm, q16, 0.0, reps=1, warmup=1)
    assert meas["n_messages"] == build_schedule(plan, 0.0).num_messages
    assert len(meas["per_message"]) == meas["n_messages"]
    assert meas["total_us"] > 0.0
    cal = calibrate("tiny", t, sm, q16, reps=1)
    assert _calibration_counts(cal) == obs_run.ref("calibrate")
    for label, th in cal["thresholds"].items():
        for k in ("model_error_ratio_default", "model_error_ratio_fitted"):
            assert th[k] > 0.0 and math.isfinite(th[k]), (label, k)
        assert th["exposed_comm_us_measured"] > 0.0
    json.dumps(cal)


def test_quickstart_matches_reference(obs_run):
    """repro_torch.quickstart against examples/quickstart.py: show_schedule
    and show_wire print the reference's lines; show_trace's traced wire
    step (the 64 KiB schedule) has a message span for each of the
    messages the reference's show_schedule counts there."""
    import re
    from repro_torch import quickstart as Q
    ref = obs_run.ref("quickstart")
    assert _printed(Q.show_schedule) == ref["show_schedule"]
    assert _printed(Q.show_wire) == ref["show_wire"]
    got = _printed(Q.show_trace, "cpu")
    n = int(re.search(r"fused 64KiB : *(\d+) messages",
                      ref["show_schedule"][1]).group(1))
    assert got[1].startswith(f"  ({n} wire messages -> {n} message spans")
    assert got[0].startswith(f"  step 0: {n} message spans")


# ---- the Engine, the streams and the train CLI (the rank spawn) -------------------

def test_engine_trace_and_gauges_match_reference(obs_run):
    """The Engine on a one-rank gloo group (mamba2 smoke, QSGD(16)
    layerwise, per-bucket schedule): exactly num_messages message spans a
    step on the simulated and the wire path (its stages compress, pack,
    decode, collective), counters and gauges the reference's
    (comm_plans / build_schedule / payload_bits_per_step), params after
    2 steps bitwise equal untraced, with a disabled tracer and traced."""
    eng = obs_run.ranks()[0]["engine"]
    ref = obs_run.ref("engine")
    assert eng["n_messages"] == ref["n_messages"]
    for path in ("sim", "wire"):
        r = eng[path]
        assert r["spans"] == [ref["n_messages"]] * 2, path
        assert [s["n_message_spans"] for s in r["summaries"]] == \
            [ref["n_messages"]] * 2
        assert r["counters"] == ref["counters"], path
        assert r["gauges"] == ref["gauges"], path
        for tag in ("bare", "off"):
            for k, v in r["runs"]["traced"].items():
                assert v.tobytes() == r["runs"][tag][k].tobytes(), \
                    (path, tag, k)
        for s in r["summaries"]:
            assert round(sum(v * 1000 for v in s["stage_us"].values())) \
                <= round(s["wall_us"] * 1000)
    assert ref["gauges"]["engine/n_messages"] == ref["n_messages"]
    assert ref["gauges"]["engine/n_dispatches"] == ref["n_dispatches"]
    assert ref["gauges"]["engine/wire_bits_per_step"] == ref["payload_bits"]
    assert eng["plain"] == ref["plain"]
    for st in eng["wire"]["stages"].values():
        assert {s for s, _ in st} == {"compress", "pack", "decode",
                                      "collective"}


@pytest.mark.parametrize("case", [f"{m}/{fb}/{c}" for m, fb, c in
                                  STREAM_CASES] + ["collective"])
def test_streams_hops_and_bytes_match_reference(obs_run, case):
    """measure_stream (ring, rs) and measure_collective on 2 gloo ranks:
    hop spans == n_messages x (n - 1) on every rank, bytes and chunks the
    reference's message_layouts / shard_message_layouts / layout_chunks."""
    want = obs_run.ref("layouts")[case]
    for rank, r in enumerate(obs_run.ranks()):
        got = r["streams"][case]
        assert got["n_messages"] == want["n_messages"], (rank, case)
        assert got["wire_bytes"] == want["wire_bytes"], (rank, case)
        if case == "collective":
            assert got["n_workers"] == RANKS
            assert {"compress", "pack", "decode", "collective"} <= \
                set(got["stage_us"])
            continue
        assert got["n_hops"] == want["n_hops"] == \
            got["n_hop_spans_measured"], (rank, case)
        assert [[m["message"], m["wire_bytes"], m["n_chunks"],
                 m["hop_bytes"]] for m in got["per_message"]] == \
            want["per_message"], (rank, case)
        assert got["hop_bytes_total"] == sum(m[3] for m in
                                             want["per_message"])
        assert {"compress", "pack", "decode", "hop", "collective"} <= \
            set(got["stage_us"])


def test_train_cli_trace_and_metrics_match_reference(obs_run):
    """train --trace-out / --metrics-out on 2 CPU ranks: rank 0's lines
    carry the reference's metric names, counters and gauges (the
    reference's CLI at --data 1), message spans a step equal the
    reference's, and the printed summary / export lines are the
    reference's."""
    from repro_torch.obs import read_jsonl, validate_chrome_trace
    ranks = obs_run.ranks()
    out = obs_run.ref_train()
    got = read_jsonl(str(out / "port_train_metrics.jsonl"))
    want = read_jsonl(str(out / "ref_train_metrics.jsonl"))
    assert [l["labels"] for l in got] == [l["labels"] for l in want]
    for g, w in zip(got, want):
        assert g["counters"] == w["counters"]
        assert g["gauges"] == w["gauges"]
        assert sorted(g["histograms"]) == sorted(w["histograms"])
    gt = json.loads((out / "port_train_trace.json").read_text())
    wt = json.loads((out / "ref_train_trace.json").read_text())
    validate_chrome_trace(gt)

    def per_step(obj):
        return [s["n_message_spans"] for s in obj["metadata"]["steps"]]
    assert per_step(gt) == per_step(wt) and len(per_step(gt)) == 2
    ref_lines = (out / "ref_train_lines.txt").read_text().splitlines()

    def tagged(lines):
        return [l.split(" ", 1)[0] for l in lines
                if l.startswith(("trace ->", "metrics ->", "step 1:"))]
    assert tagged(ranks[0]["lines"]) == tagged(ref_lines)
    assert ranks[1]["lines"] == []
    assert ranks[0]["cli"]["losses"] == ranks[1]["cli"]["losses"]
