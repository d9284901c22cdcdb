"""Rank processes for the collectives (the port's counterpart of the JAX
package's launch/mesh.py, whose mesh axes become a torch.distributed
process group).

`run_ranks(fn, n, backend=..., device=...)` starts n processes with
torch.multiprocessing (start method spawn: CUDA cannot fork), opens the
process group in each over TCP on a free localhost port, runs
`fn(rank, n, device, *args)` there, tears the group down and returns the
ranks' results in rank order. The caller names the backend and the
device; nothing is chosen for it:

  gloo, "cpu"    every rank on the CPU
  gloo, "cuda"   every rank on cuda:0 (one card shared by all ranks; gloo
                 takes CUDA tensors and stages them through host memory)
  nccl, "cuda"   rank r on cuda:r, only with at least n cards (NCCL
                 refuses two ranks on one device)

A rank that raises fails the whole run with its traceback; a run that
outlasts `timeout` seconds is terminated and raises TimeoutError, and the
process group's own timeout turns a collective that never completes into
an error inside the ranks. `fn` must be importable (a module-level
function) and return picklable host data (numbers, numpy arrays).
"""
from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device rank `rank` computes on."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _check(backend: str, device: str, n: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl runs on CUDA devices only")
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device='cuda' but torch sees no CUDA device")
        if backend == "nccl" and cards < n:
            raise ValueError(f"nccl needs one card per rank: {n} ranks, "
                             f"{cards} card(s); use gloo to share a card")


def _rank_main(fn, rank, n, backend, device, port, args, out, pg_timeout):
    try:
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=pg_timeout))
        try:
            result = fn(rank, n, dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n: int, *, backend: str, device: str, args=(),
              timeout: float = 600.0):
    """Run fn(rank, n, device, *args) in n spawned rank processes joined in
    one process group -> [result of rank 0, ..., rank n-1]."""
    _check(backend, device, n)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, device, port, args, out,
                               timeout), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(results)} of {n} ranks did not "
                                   f"finish within {timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        out.close()
    return [results[r] for r in range(n)]
