"""Multi-pod dry run (the JAX package's launch/dryrun.py): for every (arch x
shape x mesh), one rank's train, prefill or serve step on meta tensors,
counted op by op.

The reference lowers and compiles each step on 512 virtual devices and
reads memory, FLOPs and collective bytes off the compiled artifact. The
port compiles nothing: it opens a process group of the mesh's size on
PyTorch's fake backend (this process is rank 0; its collectives move no
data and return outputs of the right shape) and runs rank 0's step on
meta tensors (no storage) under hlo_cost.StepCost:

  params   the rank's shards (Engine.local_shapes)
  inputs   the global batch (Engine.batch_shapes; the step takes its own
           rows), a decode step's cache shard, `pos` the last slot
  counted  flops, the HBM-bytes model, each collective as the reference
           HLO op it stands for, and the live bytes (memory_analysis)

Each row is the reference's Roofline JSON (`{tag}.json`, appended to
`summary.json`) with its `tpu_estimate_total` / `tpu_estimate_fits_16g`
(Engine.memory_estimate) and the card's name and memory: with `--device
cuda` (the default) the visible card's, failing without one; with
`--device cpu` the data sheet's 80 GB (`card_source` says which).
`fits_card` holds the traced peak (arguments + temp) against the card,
`estimate_fits_card` the estimate. The Roofline's collective term is the
reference's ops' wire bytes (a ring all-reduce's 2 (g - 1) / g x its
result); beside it, `port_collective_bytes_per_device` (by collective in
`port_collective_breakdown`) is what the port's own collectives received
(an all-reduce's all_gather: (g - 1) x), with `port_t_collective` at the
same link rate and `port_bottleneck` the largest of t_compute, t_memory
and that. `lower_s` is the set-up (engine, mesh
and meta inputs), `compile_s` the traced step. `--save-hlo` writes the
counted ops (the port has no HLO) to `{tag}.ops.txt`.

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape train_4k --mesh both --device cpu

A process that already holds a process group cannot run it (one default
group a process); the dry run's group is destroyed when it ends.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_NAMES, config_for_shape
from repro_torch.core import CompressionConfig, Granularity, make_compressor
from repro_torch.launch.analysis import (CARD_BYTES, ICI_BW, analyze_step,
                                         save_roofline)
from repro_torch.launch.engine import Engine
from repro_torch.launch.hlo_cost import StepCost
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.optim import OptConfig, init_opt_state

OUT = os.path.join("chiprun_out", "dryrun")
DATA_SHEET_CARD = "NVIDIA H100 SXM5 80GB (data sheet)"


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
        qm=(make_compressor(args.qm) if args.qm != "identity"
            else make_compressor("identity")),
        granularity=Granularity(args.granularity, args.block_size),
        strategy=args.strategy,
        wire_dtype=args.wire_dtype)


def card(device: str):
    """(name, total bytes, source) of the card a row is held against: the
    visible card's with device "cuda" (raises without one), the data
    sheet's H100 with "cpu"."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda reads the visible card, and "
                               "torch sees none; pass --device cpu for the "
                               "data sheet's 80 GB")
        p = torch.cuda.get_device_properties(0)
        return p.name, float(p.total_memory), "device"
    if device != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    return DATA_SHEET_CARD, CARD_BYTES, "data sheet (--device cpu)"


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of `world` ranks on PyTorch's fake backend, this
    process rank 0, destroyed on exit."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("the dry run opens its own (fake) process group; "
                           "this process already has one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        from repro_torch.models.dist import bind_axes
        bind_axes({})
        dist.destroy_process_group()


def local_cache(eng: Engine, shape):
    """Meta tensors of this rank's cache shard for a decode shape: the
    cache's global shapes cut by its partition (Model.cache_pspecs)."""
    sharded = shape.global_batch % eng.dp_size == 0
    specs = eng.model.cache_pspecs(sharded)

    def cut(t, spec):
        dims = list(t.shape)
        for i, ax in enumerate(spec):
            if ax is not None:
                dims[i] //= eng.mesh.axis_size(
                    ax if isinstance(ax, tuple) else (ax,))
        return torch.empty(dims, dtype=t.dtype, device="meta")

    def walk(c, s):
        if c is None:
            return None
        if isinstance(c, torch.Tensor):
            return cut(c, s)
        if isinstance(c, dict):
            return {k: walk(v, s[k]) for k, v in c.items()}
        return type(c)(walk(v, sv) for v, sv in zip(c, s))
    return walk(eng.model.cache_shapes(shape.seq_len, shape.global_batch),
                specs)


def step_inputs(eng: Engine, shape):
    """(the step, its arguments) of one rank for `shape`, on meta tensors."""
    params = eng.local_shapes()
    batch = eng.batch_shapes(shape)
    if shape.kind == "train":
        opt_state = init_opt_state(eng.opt, params)
        # the plans are built before the step, as the reference builds
        # them at trace time (their shape placeholders are no live bytes)
        eng.comm_plans()
        return eng.build_train_step(), (params, opt_state, batch, 0)
    if shape.kind == "prefill":
        return eng.build_prefill(shape), (params, batch)
    batch["pos"] = shape.seq_len - 1        # a host int (decode_step reads it)
    return eng.build_serve_step(shape), (params, batch,
                                         local_cache(eng, shape))


def count_step(step, args) -> StepCost:
    """Run `step(*args)` under a StepCost -> the cost."""
    cost = StepCost()
    cost.arguments(*args)
    with cost:
        out = step(*args)
    cost.outputs(out)
    return cost


def run_one(arch: str, shape_name: str, multi_pod: bool, comp, opt,
            out_dir: str, remat: bool = True, save_hlo: bool = False,
            microbatch: int = 0, tag_suffix: str = "",
            capacity_factor: float = 0.0, mesh_shape=None,
            kv_int8: bool = False, device: str = "cuda"):
    shape = INPUT_SHAPES[shape_name]
    cfg, note = config_for_shape(arch, shape_name)
    if cfg is not None and microbatch:
        cfg = dataclasses.replace(cfg, train_microbatch=microbatch)
    if cfg is not None and capacity_factor:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    if cfg is not None and kv_int8 and cfg.attention == "gqa":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}{tag_suffix}"
    if cfg is None:
        print(f"[skip] {tag}: {note}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "note": note}
    card_name, card_bytes, card_source = card(device)
    t0 = time.time()
    if mesh_shape:
        mesh_name = "x".join(str(s) for s in mesh_shape)
        tag = f"{arch}__{shape_name}__{mesh_name}{tag_suffix}"
        chips = mesh_shape[0] * mesh_shape[1]
    else:
        chips = 512 if multi_pod else 256
    with fake_group(chips):
        mesh = (make_mesh(mesh_shape, ("data", "model")) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod))
        eng = Engine(cfg, mesh, comp=comp, opt=opt, remat=remat,
                     device="meta")
        step, args = step_inputs(eng, shape)
        t_lower = time.time() - t0
        cost = count_step(step, args)
        t_compile = time.time() - t0 - t_lower

    roof = analyze_step(cost, arch=arch, shape=shape, mesh_name=mesh_name,
                        chips=chips, cfg=cfg)
    est = eng.memory_estimate(shape)
    mem = roof.memory_per_device
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    mem["tpu_estimate_total"] = est["total"]
    mem["tpu_estimate_fits_16g"] = float(est["fits_16g"])
    mem["card_total_bytes"] = card_bytes
    mem["fits_card"] = float(peak <= card_bytes)
    mem["estimate_fits_card"] = float(est["total"] <= card_bytes)
    print(cost.memory_analysis())
    print("tpu_estimate:", {k: (round(v / 1e9, 3) if isinstance(v, float)
                                else v) for k, v in est.items()})
    print({"flops": cost.flops, "bytes accessed": cost.bytes})
    print(f"card: {card_name} ({card_source}) {card_bytes / 1e9:.1f} GB: "
          f"traced peak {peak / 1e9:.3f} GB fits={bool(mem['fits_card'])}, "
          f"estimate {est['total'] / 1e9:.3f} GB "
          f"fits={bool(mem['estimate_fits_card'])}")
    os.makedirs(out_dir, exist_ok=True)
    save_roofline(roof, os.path.join(out_dir, f"{tag}.json"))
    if save_hlo:
        with open(os.path.join(out_dir, f"{tag}.ops.txt"), "w") as f:
            for name, n in sorted(cost.ops.items()):
                f.write(f"{name} {n}\n")
            for name, n in sorted(cost.kernels.items()):
                f.write(f"kernel:{name} {n}\n")
    d = roof.to_dict()
    port = float(sum(cost.port_collectives.values()))
    terms = {"compute": roof.t_compute, "memory": roof.t_memory,
             "collective": port / ICI_BW}
    d.update(port_collective_bytes_per_device=port,
             port_collective_breakdown=dict(cost.port_collectives),
             port_t_collective=terms["collective"],
             port_bottleneck=max(terms, key=terms.get))
    d.update(status="ok", note=note, lower_s=round(t_lower, 1),
             compile_s=round(t_compile, 1), card=card_name,
             card_source=card_source)
    print(f"[ok] {tag}: bottleneck={roof.bottleneck} "
          f"t=({roof.t_compute:.4f},{roof.t_memory:.4f},"
          f"{roof.t_collective:.4f})s useful={roof.useful_flops_ratio:.3f} "
          f"lower={t_lower:.0f}s compile={t_compile:.0f}s")
    return d


def parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_NAMES} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--compressor", default="topk",
                    help="none|randomk|topk|threshold_v|adaptive_threshold|"
                         "terngrad|qsgd|signsgd|natural")
    ap.add_argument("--ratio", type=float, default=0.01)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--qm", default="identity")
    ap.add_argument("--granularity", default="layerwise",
                    choices=["layerwise", "entire_model", "blockwise"])
    ap.add_argument("--block-size", type=int, default=65536)
    ap.add_argument("--strategy", default="simulated")
    ap.add_argument("--wire-dtype", default="float32")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--mesh-shape", default="",
                    help="override: 'data,model' e.g. '64,4' (analysis runs)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache (GQA archs)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the counted ops to {tag}.ops.txt")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="whose memory a row is held against: the visible "
                         "card's, or the data sheet's 80 GB")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    card(args.device)                   # no card with --device cuda: fail
    comp = build_compression(args)
    opt = OptConfig(name=args.optimizer)
    archs = ARCH_NAMES if args.arch == "all" else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.shape == "all" else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]

    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_one(
                        arch, shape, mp, comp, opt, args.out,
                        remat=not args.no_remat, save_hlo=args.save_hlo,
                        microbatch=args.microbatch, tag_suffix=args.tag,
                        capacity_factor=args.capacity_factor,
                        mesh_shape=tuple(int(x) for x in
                                         args.mesh_shape.split(","))
                        if args.mesh_shape else None,
                        kv_int8=args.kv_int8, device=args.device))
                except Exception:
                    failures += 1
                    tagm = "2x16x16" if mp else "16x16"
                    print(f"[FAIL] {arch}__{shape}__{tagm}")
                    traceback.print_exc()
                    if args.fail_fast:
                        raise
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "a") as f:
        json.dump(results, f, indent=1)
        f.write("\n")
    print(f"\n{len(results)} ok / {failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
