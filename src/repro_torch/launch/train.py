"""Training launcher: compressed data-parallel training of any --arch across
real ranks (the JAX package's launch/train.py, same flags and printed
lines).

`--data N --model M` starts N x M rank processes (launch/mesh.run_ranks)
on a (data, model) mesh, rank = d * M + m, where the reference ran one
process over N x M virtual devices; rank 0 prints. The model axis is
tensor (and sequence) parallel; configs with use_fsdp shard their params
over the data axis too. `--device cuda` (the default) runs every rank on the card: over
nccl (the default there) rank r on cuda:r, which needs N cards; over
`--backend gloo` all ranks share cuda:0. `--device cpu` runs on the CPU
over gloo. Nothing switches over silently: nccl with fewer cards than
ranks raises run_ranks' error, which names --backend gloo.

The batches are the reference's Markov stream (data/synthetic.py
lm_batches), drawn on the CPU from --seed on every rank and moved to its
device, so the card and the CPU train on the same tokens; rank r takes
rows [d B / N, (d + 1) B / N) of each global batch of --batch, d its
data index. The
Markov matrix is (vocab, vocab): at a full-width vocab no host holds it,
as in the reference.

--ckpt-dir / --ckpt-every / --resume checkpoint and resume as the
reference (ckpt/checkpoint.py, its file format): the state is gathered
to its global arrays and rank 0 writes; a resume cuts every rank's
shards from that file and replays the data stream to its step, so it
ends bitwise where the uninterrupted run does. --policy routes the run through the
adaptive controller (control/: engine_controller on every rank; the
telemetry is averaged over the ranks, so every rank takes the same
decisions) with --replan-every, --variance-budget, --bit-budget and
--alpha-us; --telemetry-out writes its report from rank 0 (and implies
--policy static). --trace-out writes rank 0's trace (obs.TraceRecorder:
a span per message and stage of every step, CUDA events on the card, the
step finalized after it) as Chrome trace-event JSON, --metrics-out rank
0's counters and gauges (obs.MetricsRegistry: engine/*, controller/*,
train/steps and, under --step-guard, resil/steps_skipped) as JSON lines;
the other ranks record nothing. --error-feedback raises the reference's
ValueError (the engine threads no EF state).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-405b \\
      --smoke --steps 4 --data 2 --device cpu --backend gloo \\
      --compressor qsgd --granularity layerwise --wire
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-405b \\
      --smoke --steps 6 --data 2 --device cpu --backend gloo \\
      --compressor topk --ratio 0.1 --policy granularity_switch \\
      --replan-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-405b \\
      --smoke --steps 4 --data 2 --model 2 --device cpu --backend gloo \\
      --compressor qsgd --granularity layerwise --wire
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.ckpt import (host_state, latest_checkpoint,
                              load_sharded_checkpoint,
                              save_sharded_checkpoint)
from repro_torch.configs.registry import ARCH_NAMES, get_config, get_smoke
from repro_torch.control import POLICIES, engine_controller, make_policy
from repro_torch.convert import tree_leaves
from repro_torch.core import CompressionConfig, Granularity, make_compressor
from repro_torch.data import frames_stub, lm_batches, patches_stub
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.optim import OptConfig, piecewise_linear

# seconds the ranks (and any one collective) may take before the run stops
RANK_TIMEOUT = 3600.0


def build_controller(args, eng, sched, *, metrics=None, tracer=None):
    """The reference's controller over the engine: the policy by name with
    its CLI knobs; telemetry is collected when the policy reads it or
    --telemetry-out asks for the report."""
    kw = {}
    if args.policy == "variance_budget":
        kw["budget"] = args.variance_budget
    if args.policy == "bit_budget":
        kw["bits_per_step"] = args.bit_budget
    if args.policy == "fusion":
        kw["alpha_us"] = args.alpha_us
    policy = make_policy(args.policy, **kw)
    collect = policy.needs_telemetry or bool(args.telemetry_out)
    return engine_controller(eng, policy, lr_schedule=sched,
                             replan_every=args.replan_every,
                             collect_telemetry=collect,
                             metrics=metrics, tracer=tracer)


def build_compression(args) -> CompressionConfig:
    if args.compressor == "none":
        return CompressionConfig(strategy="dense")
    kw = {}
    if args.compressor in ("randomk", "topk"):
        kw["ratio"] = args.ratio
    if args.compressor == "qsgd":
        kw["levels"] = args.levels
    return CompressionConfig(
        qw=make_compressor(args.compressor, **kw),
        qm=make_compressor(args.qm),
        granularity=Granularity(args.granularity, args.block_size),
        strategy=args.strategy,
        error_feedback=args.error_feedback,
        fusion_bytes=args.fusion_bytes)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="mamba2-1.3b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--compressor", default="none")
    ap.add_argument("--ratio", type=float, default=0.01)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--qm", default="identity")
    ap.add_argument("--granularity", default="layerwise",
                    choices=["layerwise", "entire_model", "blockwise"])
    ap.add_argument("--block-size", type=int, default=65536)
    ap.add_argument("--strategy", default="simulated")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--fusion-bytes", type=float, default=None,
                    help="comm-schedule fusion threshold in bytes: stream "
                         "aggregation through the backward-ordered "
                         "CommSchedule, fusing buckets below this size "
                         "into one wire message (0 = per-bucket messages, "
                         "inf = one message; default: unscheduled)")
    ap.add_argument("--alpha-us", type=float, default=50.0,
                    help="per-message link latency for the fusion policy "
                         "and the modeled comm report")
    ap.add_argument("--wire", action="store_true",
                    help="materialize compression as real bit-packed wire "
                         "payloads: every message is a uint8 buffer, "
                         "bit-identical numerics; prints accounted vs "
                         "measured wire bits")
    ap.add_argument("--collective", default=None,
                    choices=("allgather", "ring"),
                    help="wire-collective topology (requires --wire): "
                         "'allgather' gathers every payload, 'ring' "
                         "streams the same messages around the ring "
                         "(bit-identical numerics)")
    ap.add_argument("--policy", default=None, choices=list(POLICIES),
                    help="adaptive compression policy; routes the run "
                         "through the control Controller (default: the "
                         "static engine path without telemetry)")
    ap.add_argument("--replan-every", type=int, default=20,
                    help="policy re-plan boundary, in steps")
    ap.add_argument("--telemetry-out", default="",
                    help="write the controller's per-window telemetry "
                         "summaries and switch log as JSON from rank 0 "
                         "(implies --policy static when no policy is "
                         "given)")
    ap.add_argument("--trace-out", default="",
                    help="record rank 0's per-step / per-message spans "
                         "with the obs.TraceRecorder and write a Chrome "
                         "trace-event JSON (open in Perfetto). Each step "
                         "is finalized after it (one synchronize on the "
                         "card)")
    ap.add_argument("--metrics-out", default="",
                    help="write rank 0's engine / controller / train "
                         "counters and gauges as JSON lines "
                         "(obs.MetricsRegistry)")
    ap.add_argument("--variance-budget", type=float, default=0.1,
                    help="variance_budget policy: max relative "
                         "compression error per bucket")
    ap.add_argument("--bit-budget", type=int, default=1 << 22,
                    help="bit_budget policy: uplink payload bits/step")
    ap.add_argument("--optimizer", default="momentum")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--nesterov", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore params / optimizer from the newest "
                         "checkpoint in --ckpt-dir and continue from its "
                         "step; the data stream is replayed to that step, "
                         "so an uninterrupted run and a killed-and-resumed "
                         "run end bitwise equal")
    ap.add_argument("--step-guard", action="store_true",
                    help="drop any update whose loss or aggregated "
                         "gradient is non-finite on any rank")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process-group backend: nccl on cuda (one card a "
                         "rank), gloo on cpu (and to share one card)")
    return ap


def _parse(argv):
    ap = parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume restores from --ckpt-dir; set it")
    if args.telemetry_out and not args.policy:
        args.policy = "static"  # telemetry collection needs the controller
    comp = build_compression(args)
    if args.wire and args.policy:
        ap.error("--wire is the static engine path; drop --policy")
    if args.step_guard and args.policy:
        ap.error("--step-guard is the static engine path; drop --policy")
    if args.collective and not args.wire:
        ap.error("--collective picks the wire collective's topology; "
                 "add --wire")
    if args.collective and comp.strategy == "dense":
        ap.error("--collective needs a compressor (the dense path has no "
                 "wire messages to stream); add --compressor")
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    return args


def _engine(args, device) -> Engine:
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(data=args.data, model=args.model)
    opt = OptConfig(name=args.optimizer, lr=args.lr, nesterov=args.nesterov)
    return Engine(cfg, mesh, comp=build_compression(args), opt=opt,
                  device=device)


def _summary(args, eng: Engine, params, say) -> None:
    """The reference's header lines: arch / mesh / comp, the plan, the
    wire bits and the schedule."""
    cfg, comp = eng.cfg, eng.comp
    n = sum(x.numel() for x in tree_leaves(eng.model.param_shapes()))
    say(f"arch={cfg.name} params={n/1e6:.2f}M mesh={dict(eng.sizes)} "
        f"comp={comp.strategy}/{comp.qw.name}/{comp.granularity.kind}"
        + (f" collective={args.collective}" if args.collective else "")
        + (f" policy={args.policy}/replan={args.replan_every}"
           if args.policy else ""))
    rest_plan, fsdp_plan = eng.comm_plans()
    for tag, p in (("dp", rest_plan), ("fsdp", fsdp_plan)):
        if p is not None:
            say(f"plan[{tag}]: {p.summary()}")
    if args.wire and rest_plan is not None and comp.strategy != "dense":
        from repro_torch.core.wire import wire_codec
        codec = wire_codec(comp.qw)
        acct = sum(comp.qw.payload_bits(d) for d in rest_plan.unit_dims)
        meas = sum(codec.wire_bits(d) for d in rest_plan.unit_dims)
        say(f"wire[dp]: codec={codec.name} accounted={acct} bits "
            f"measured={meas} bits (padding {meas - acct})")
    if args.fusion_bytes is not None and rest_plan is not None:
        from repro_torch.launch.comm_sched import (engine_schedule,
                                                   schedule_report)
        s = engine_schedule(eng, args.fusion_bytes)
        rep = schedule_report(s, comp, eng.dp_size, alpha_us=args.alpha_us)
        say(f"schedule[dp]: {s.summary()}")
        say(f"schedule[dp]: modeled exposed comm "
            f"{rep['model']['exposed_comm_us']:.0f}us of "
            f"{rep['model']['comm_us_total']:.0f}us "
            f"(overlap {rep['model']['overlap_frac']:.0%}; model, not "
            f"measurement — trust the message counts)")


def _batch(cfg, it, key, i, batch, dev):
    """The next global batch, drawn on the CPU, on `dev`."""
    b = {k: v.to(dev) for k, v in next(it).items()}
    if cfg.arch_type == "vlm":
        b["patch_embeds"] = patches_stub(R.fold_in(key, i), batch,
                                         cfg.frontend_seq, cfg.d_model,
                                         device="cpu").to(dev)
    if cfg.arch_type == "audio":
        b["frames"] = frames_stub(R.fold_in(key, i), batch,
                                  cfg.frontend_seq, cfg.d_model,
                                  device="cpu").to(dev)
    return b


def _train_rank(rank, n, dev, args, collect):
    """One rank of the run -> {"losses", "start", "launches", "wire",
    "controller"[, "state"]}; "controller" (None without --policy) has the
    decision in force at each step and the final decision, builds and
    switches."""
    from repro_torch import kernels
    from repro_torch.core import collectives
    from repro_torch.experiment import _full_precision
    _full_precision()
    if dev.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    say = ((lambda *a: print(*a, flush=True)) if rank == 0
           else (lambda *a: None))
    eng = _engine(args, dev)
    cfg = eng.cfg
    sched = piecewise_linear(args.lr, args.steps, max(1, args.steps // 10))
    rec = reg = None
    if rank == 0 and (args.trace_out or args.metrics_out):
        from repro_torch.obs import MetricsRegistry, TraceRecorder
        rec = TraceRecorder(pid=rank) if args.trace_out else None
        reg = MetricsRegistry() if args.metrics_out else None
    ctrl = (build_controller(args, eng, sched, metrics=reg, tracer=rec)
            if args.policy else None)
    step_fn = None if ctrl else eng.build_train_step(
        sched, wire=args.wire, collective=args.collective, tracer=rec,
        metrics=reg, step_guard=args.step_guard)
    params, opt_state = eng.init_state(args.seed)
    start = 0
    if args.resume:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck is not None:
            start, state = load_sharded_checkpoint(ck, eng)
            params, opt_state = state["params"], state["opt"]
            say(f"resume: {ck} -> step {start}")
        else:
            say(f"resume: no checkpoint under {args.ckpt_dir!r}, "
                f"starting fresh")
    _summary(args, eng, params, say)

    it = lm_batches(cfg.vocab, args.batch, args.seq, seed=args.seed,
                    device="cpu")
    for _ in range(start):   # replay the stream to the resume point: the
        next(it)             # resumed run sees the uninterrupted run's
    key = R.key(args.seed)   # batches
    kernels.reset_launch_counts()
    collectives.reset_counts()
    losses, skipped, decisions = [], 0, []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = _batch(cfg, it, key, i, args.batch, dev)
        if ctrl is not None:
            decisions.append(ctrl.decision.describe())
            fn = ctrl.step_fn()
            if ctrl.collect:
                params, opt_state, m, telem = fn(params, opt_state, batch,
                                                 i, ctrl.telemetry)
            else:
                params, opt_state, m = fn(params, opt_state, batch, i)
                telem = None
            if ctrl.observe(telem, i):
                say(f"step {i:5d} replan -> {ctrl.decision.describe()}")
        else:
            params, opt_state, m = step_fn(params, opt_state, batch, i)
        if rec is not None:
            rec.finalize_step(i)
        if reg is not None:
            reg.inc("train/steps")
            if args.step_guard:
                reg.inc("resil/steps_skipped", float(m["skipped"]))
            reg.record(step=i)
        loss = float(m["loss"])
        losses.append(loss)
        skipped += int(m.get("skipped", 0.0))
        if i % max(1, args.steps // 20) == 0 or i == args.steps - 1:
            say(f"step {i:5d} loss {loss:.4f} lr {float(m['lr']):.4f} "
                f"({time.time() - t0:.1f}s)")
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            save_sharded_checkpoint(args.ckpt_dir, i + 1,
                                    {"params": params, "opt": opt_state},
                                    eng)
            dist.barrier()
    report = None
    if ctrl is not None:
        say(f"controller: decision={ctrl.decision.describe()} "
            f"builds={ctrl.builds} switches={len(ctrl.switches)}")
        if args.telemetry_out and rank == 0:
            ctrl.export(args.telemetry_out)
            say(f"telemetry -> {args.telemetry_out}")
        report = {"decisions": decisions, "report": ctrl.report()}
    if rec is not None:
        from repro_torch.obs import format_step_summary
        if rec.steps:
            say(format_step_summary(rec.steps[-1]))
        rec.export(args.trace_out)
        say(f"trace -> {args.trace_out} "
            f"({len(rec.events)} events, {len(rec.steps)} steps)")
    if reg is not None:
        if ctrl is not None:
            ctrl.check_retraces()  # stamp the final retrace gauge
        n_lines = reg.export_jsonl(args.metrics_out)
        say(f"metrics -> {args.metrics_out} ({n_lines} lines)")
    out = {"losses": losses, "start": start, "skipped": skipped,
           "launches": kernels.launch_counts(),
           "wire": collectives.counts("all_gather"), "controller": report}
    if collect:
        out["state"] = host_state(eng.global_tree(
            {"params": params, "opt": opt_state}, eng.state_pspecs()))
    return out


def run(argv=None, *, collect: bool = False):
    """Parse `argv`, run the ranks -> their results in rank order: each
    rank's step losses (the group's mean, equal on every rank), its
    kernel launches and all_gather counts since the first step, and with
    `collect` its final params and optimizer state as {path: numpy}."""
    args = _parse(argv)
    resolve_device(args.device)
    # build the engine and its step once here: the errors a rank would
    # raise (a pod mesh, error feedback) raise here
    eng = _engine(args, "cpu")
    if args.policy:
        build_controller(args, eng, None).step_fn()
    else:
        eng.build_train_step(wire=args.wire, collective=args.collective,
                             step_guard=args.step_guard)
    return run_ranks(_train_rank, args.data * args.model,
                     backend=args.backend,
                     device=args.device, args=(args, collect),
                     timeout=RANK_TIMEOUT)


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
