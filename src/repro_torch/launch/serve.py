"""Serving launcher: prefill a batch of prompts and decode N tokens
greedily (the JAX package's launch/serve.py), on one device or across
`--data N --model M` rank processes (launch/mesh.run_ranks, rank =
d * M + m) through the Engine's sharded prefill and serve steps: the
batch split over the data axis, heads, vocab and the cache's slots over
the model axis. Rank 0 prints.

Runs on the card unless `--device cpu` is given; across ranks the backend
is nccl on the card (one card a rank) unless `--backend gloo` shares one
card, gloo on the CPU. The params come from `Model.init(key(seed))` (each
rank cuts its shards from the same draw, so a sharded run serves the
one-device run's model where the heads divide the model axis; TP padding
heads change the declared shapes, as in the reference) and the prompts are uniform tokens drawn on the
device (a torch.Generator seeded from the key: not the reference's
draws); a VLM gets patch embeddings, an audio model frame embeddings,
from the same key. Times are CUDA events on the card (host clocks on the
CPU).

--trace-out writes rank 0's spans (obs.TraceRecorder host spans: one
prefill, one decode a step, each closed over finished work: on the card
an event pair whose end is synchronized) as Chrome trace-event JSON;
--metrics-out rank 0's counters serve/requests and serve/tokens, the
gauge serve/prefill_us and the histogram serve/decode_us (one sample a
decode step, from a CUDA event pair on the card) as JSON lines.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --smoke --device cpu --batch 8 --prompt 24 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --smoke --device cpu --model 2
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_NAMES, get_config, get_smoke
from repro_torch.data import frames_stub, patches_stub
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models import DistConfig, InputShape, Model

# seconds the ranks (and any one collective) may take before the run stops
RANK_TIMEOUT = 3600.0



def pack_request(token: torch.Tensor, pos) -> torch.Tensor:
    """Serving wire format: one decode request as one uint8 buffer, the
    uint32 words [batch, pos, token_0, ..., token_{B-1}] as little-endian
    bytes (the reference's bytes), on the token's device."""
    if sys.byteorder != "little":
        raise RuntimeError("pack_request assumes a little-endian host")
    dev = token.device
    head = torch.stack([torch.full((), token.shape[0], dtype=torch.int32,
                                   device=dev),
                        torch.as_tensor(pos, dtype=torch.int32).to(dev)])
    return torch.cat([head, token.to(torch.int32)]).view(torch.uint8)


def unpack_request(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of pack_request -> {"token": int32 (B,), "pos": int32 0-d}."""
    words = buf.reshape(-1).view(torch.int32)
    return {"token": words[2:], "pos": words[1]}


class _Clock:
    """Elapsed ms between start() and stop(): CUDA events on the card,
    the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        self.mark()
        if self.cuda:
            self.t1.synchronize()
        return self.elapsed_ms()

    def mark(self) -> None:
        """The end of the timed work, not waited for."""
        if self.cuda:
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t1.record()
        else:
            self.t1 = time.perf_counter()

    def elapsed_ms(self) -> float:
        """start() to mark(), once the work before mark() has finished."""
        if self.cuda:
            return self.t0.elapsed_time(self.t1)
        return (self.t1 - self.t0) * 1e3


def make_batch(cfg, batch: int, prompt: int, seed: int, dev) -> Dict:
    """The launcher's inputs: uniform prompt tokens (batch, prompt) drawn on
    the device, plus patch or frame embeddings for a VLM or audio model."""
    key = R.key(seed)
    g = R.generator(key, dev)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt),
                                   generator=g, device=dev)}
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = patches_stub(key, batch, cfg.frontend_seq,
                                           cfg.d_model, device=dev)
    if cfg.arch_type == "audio":
        out["frames"] = frames_stub(key, batch, cfg.frontend_seq,
                                    cfg.d_model, device=dev)
    return out


def generate(model: Model, params, batch: Dict, gen: int,
             forced: Optional[torch.Tensor] = None,
             keep_logits: bool = False,
             engine: Optional[Engine] = None, recorder=None,
             metrics=None) -> Dict:
    """Prefill, then gen - 1 greedy decode steps (gen tokens in all). The
    first decode request is round-tripped through pack_request /
    unpack_request outside the timed region, as the reference does.
    forced (B, gen): feed forced[:, t] as the token after step t instead of
    the argmax (teacher forcing). With `engine` (its model and this rank's
    param shards) the steps are the engine's: this rank's rows and cache
    shard, the logits gathered over the vocab shards, the next tokens over
    the data ranks. -> {"tokens" (B_rows, gen), "prefill_ms", "decode_ms"
    (the gen - 1 steps), "decode_ms_per_token", "tokens_per_s" (batch x
    decode steps over decode time), "cache", and "logits" (one (B_rows, V)
    tensor a step) when keep_logits}. `recorder` (obs.trace.TraceRecorder)
    gets a "prefill" host span and a "decode" one a step, each closed over
    finished work; `metrics` (obs.metrics.MetricsRegistry) a
    serve/decode_us sample a decode step, timed by its own CUDA event
    pair on the card (read after the loop's clock has synchronized), and
    serve/tokens, serve/requests and serve/prefill_us."""
    dev = batch["tokens"].device
    Bsz, S = batch["tokens"].shape
    clock = _Clock(dev)
    if engine is None:
        def prefill(b):
            return model.prefill(params, b, cache_len=S + gen)

        def decode(token, pos, cache):
            return model.decode_step(params, token, pos, cache)
        rows = full = (lambda t: t)
    else:
        pre = engine.build_prefill(InputShape("prefill", S, Bsz, "prefill"),
                                   cache_len=S + gen)
        srv = engine.build_serve_step(InputShape("serve", S + gen, Bsz,
                                                 "decode"))

        def prefill(b):
            return pre(params, b)

        def decode(token, pos, cache):
            return srv(params, {"token": token, "pos": pos}, cache)
        rows, full = engine.gather_rows, engine.gather_logits
    rec = recorder if getattr(recorder, "enabled", False) else None
    metrics = metrics if getattr(metrics, "enabled", False) else None

    def span(name, **kw):
        return (rec.host_span(name, **kw) if rec is not None
                else contextlib.nullcontext())
    step_clocks = []
    with torch.inference_mode():
        clock.start()
        with span("prefill", batch=Bsz, prompt=S):
            logits, cache = prefill(batch)
            logits = full(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)
        prefill_ms = clock.stop()
        out, kept = [tok], [logits] if keep_logits else []
        nxt = forced[:, 0] if forced is not None else rows(tok)
        req = unpack_request(pack_request(nxt, S))
        token, pos = req["token"], int(req["pos"])
        clock.start()
        for t in range(gen - 1):
            if metrics is not None:
                step_clocks.append(_Clock(dev))
                step_clocks[-1].start()
            with span("decode", pos=pos):
                logits, cache = decode(token, pos, cache)
                logits = full(logits)
                tok = torch.argmax(logits, -1).to(torch.int32)
            if metrics is not None:
                step_clocks[-1].mark()
            out.append(tok)
            if keep_logits:
                kept.append(logits)
            token = forced[:, t + 1] if forced is not None else rows(tok)
            pos += 1
        decode_ms = clock.stop()
    if rec is not None:
        rec.finalize_step(0)
    if metrics is not None:
        for c in step_clocks:
            metrics.observe("serve/decode_us", c.elapsed_ms() * 1e3)
            metrics.inc("serve/tokens", Bsz)
        metrics.inc("serve/requests")
        metrics.gauge("serve/prefill_us", prefill_ms * 1e3)
    steps = max(1, gen - 1)
    Bsz = out[0].shape[0]
    res = {"tokens": torch.stack(out, dim=1), "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "decode_ms_per_token": decode_ms / steps,
           "tokens_per_s": Bsz * steps / (decode_ms / 1e3)
           if decode_ms > 0 else float("inf"), "cache": cache}
    if keep_logits:
        res["logits"] = kept
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-20b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="across ranks: nccl on the card (one card a "
                         "rank), gloo on the CPU or to share a card")
    ap.add_argument("--trace-out", default="",
                    help="record rank 0's prefill / decode spans "
                         "(obs.TraceRecorder) and write a Chrome "
                         "trace-event JSON (open in Perfetto)")
    ap.add_argument("--metrics-out", default="",
                    help="write rank 0's serve counters (requests, "
                         "tokens) and the per-token decode-latency "
                         "histogram as JSON lines (obs.MetricsRegistry)")
    return ap


def _obs(args, dev):
    """(recorder, registry) that --trace-out / --metrics-out ask for."""
    if not (args.trace_out or args.metrics_out):
        return None, None
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    return (TraceRecorder() if args.trace_out else None,
            MetricsRegistry() if args.metrics_out else None)


def _export(rec, reg, cfg, args, say) -> None:
    if reg is not None:
        reg.record(arch=cfg.name, batch=args.batch)
    if rec is not None:
        rec.export(args.trace_out)
        say(f"trace -> {args.trace_out} ({len(rec.events)} events)")
    if reg is not None:
        n_lines = reg.export_jsonl(args.metrics_out)
        say(f"metrics -> {args.metrics_out} ({n_lines} lines)")


def _report(cfg, res, args, mesh, say) -> None:
    say(f"arch={cfg.name} {mesh} batch={args.batch}")
    say(f"prefill({args.prompt} tok): {res['prefill_ms']:.0f} ms   "
        f"decode: {res['decode_ms_per_token']:.1f} ms/token")
    say("sample continuation:", res["tokens"][0].tolist())


def _serve_rank(rank, n, dev, args, collect):
    """One rank of a sharded serve run -> this rank's result (its rows'
    tokens, times; with `collect` its logits a step, as numpy)."""
    say = ((lambda *a: print(*a, flush=True)) if rank == 0
           else (lambda *a: None))
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    eng = Engine(cfg, make_host_mesh(data=args.data, model=args.model),
                 device=dev)
    eng.bind()
    params = eng.shard_tree(eng.model.init(R.key(args.seed), device=dev),
                            eng.model.param_pspecs())
    batch = make_batch(cfg, args.batch, args.prompt, args.seed, dev)
    rec, reg = _obs(args, dev) if rank == 0 else (None, None)
    res = generate(eng.model, params, batch, args.gen, engine=eng,
                   keep_logits=collect, recorder=rec, metrics=reg)
    _report(cfg, res, args, f"mesh={dict(eng.sizes)}", say)
    _export(rec, reg, cfg, args, say)
    out = {k: res[k] for k in ("prefill_ms", "decode_ms_per_token",
                                "tokens_per_s")}
    out["tokens"] = res["tokens"].cpu().numpy()
    out["index"] = (eng.mesh.axis_index("data"),
                    eng.mesh.axis_index("model"))
    if collect:
        out["logits"] = [t.float().cpu().numpy() for t in res["logits"]]
    return out


def run(argv=None):
    """Parse `argv` and serve: on one device -> None; across data x model
    ranks -> every rank's result in rank order."""
    args = parser().parse_args(argv)
    if args.data * args.model > 1:
        resolve_device(args.device)
        backend = args.backend or ("nccl" if args.device == "cuda"
                                   else "gloo")
        return run_ranks(_serve_rank, args.data * args.model,
                         backend=backend, device=args.device,
                         args=(args, False), timeout=RANK_TIMEOUT)
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, DistConfig())
    params = model.init(R.key(args.seed), device=dev)
    batch = make_batch(cfg, args.batch, args.prompt, args.seed, dev)
    rec, reg = _obs(args, dev)
    res = generate(model, params, batch, args.gen, recorder=rec,
                   metrics=reg)
    _report(cfg, res, args, f"device={dev}", print)
    _export(rec, reg, cfg, args, print)
    return None


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
