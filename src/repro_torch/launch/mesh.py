"""Rank processes and meshes (the port's counterpart of the JAX package's
launch/mesh.py, whose mesh axes become torch.distributed process groups).

`run_ranks(fn, n, backend=..., device=...)` starts n processes with
torch.multiprocessing (start method spawn: CUDA cannot fork), opens the
process group in each over a TCP store that the calling process hosts
on a localhost port the OS assigns and holds for the run (so runs
started side by side never share a rendezvous), runs
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

A `Mesh` is the reference's mesh as a small object: its axis names, its
shape, and this rank's process group and index along each axis, over the
group run_ranks opened. `make_host_mesh(data, model, pod=)` /
`make_mesh(shape, axes)` build one with jax.make_mesh's row-major layout,
the last axis the fastest: on a (data, model) mesh rank = d * model + m,
so the model group of rank r is the ranks d * model + 0 .. model - 1 and
its data group the ranks m, model + m, 2 model + m, .... A (pod, data,
model) mesh (rank = (p * data + d) * model + m) also gets the flattened
("pod", "data") group: the ranks of one model index in pod-major order,
XLA's device order, in which the reference's psum over ("pod", "data")
sums; this rank's index there is p * data + d. Every rank creates every
group (torch.distributed.new_group is collective) and keeps its own; the
mesh binds its axes for the model code (models.dist.bind_axes). A mesh
built where no process group is open describes shapes only (an Engine's
plans, batch shapes, memory estimate); its collectives need the group.
`make_production_mesh(multi_pod=)` is the reference's 16 x 16 (x 2 pods)
mesh: shapes only, or over a process group of 256 (512) ranks (the dry
run opens one on PyTorch's fake backend, launch/dryrun.py).
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import queue
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
#: the data-parallel axes of a pod mesh, reduced over as one group
POD_DP = ("pod", "data")


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
                             f"{cards} card(s); use backend gloo "
                             f"(--backend gloo) to share a card")


def _rank_main(fn, rank, n, backend, device, port, args, out, pg_timeout):
    try:
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        limit = datetime.timedelta(seconds=pg_timeout)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=limit)
        dist.init_process_group(backend, store=store, world_size=n,
                                rank=rank, timeout=limit)
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
    # the rendezvous: this process listens for the whole run
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, device, store.port, args,
                               out, timeout), daemon=True)
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


# ---- meshes -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and per axis this rank's process group
    (None: the axis spans every rank of the default group, or one rank)
    and its index along the axis."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    groups: Dict[str, Optional[object]] = dataclasses.field(
        default_factory=dict, compare=False)
    index: Dict[str, int] = dataclasses.field(default_factory=dict,
                                              compare=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def group(self, axis):
        """The process group of an axis, or of a tuple of axes (the
        flattened ("pod", "data") group; one axis of a tuple that names a
        single one)."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        return self.groups.get(axis)

    def axis_size(self, axis) -> int:
        """The ranks along an axis or a tuple of axes (their product)."""
        sizes = dict(zip(self.axis_names, self.shape))
        names = axis if isinstance(axis, tuple) else (axis,)
        return math.prod(sizes.get(a, 1) for a in names)

    def axis_index(self, axis) -> int:
        """This rank's index along an axis (or a tuple of axes, pod-major):
        the recorded one, else its rank in the axis' group (the default
        group's for a whole-world axis)."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if axis in self.index:
            return self.index[axis]
        if isinstance(axis, tuple):
            sizes = dict(zip(self.axis_names, self.shape))
            i = 0
            for a in axis:
                i = i * sizes.get(a, 1) + self.axis_index(a)
            return i
        n = self.axis_size(axis)
        if n == 1 or not (dist.is_available() and dist.is_initialized()):
            return 0
        return dist.get_rank(self.groups.get(axis))

    def bind(self) -> None:
        """Bind this mesh's axes for the model code (models.dist), and on a
        pod mesh the flattened ("pod", "data") axis."""
        from repro_torch.models.dist import Axis, bind_axes
        axes = {a: Axis(self.groups.get(a), n, self.axis_index(a))
                for a, n in zip(self.axis_names, self.shape)}
        if "pod" in self.axis_names:
            axes[POD_DP] = Axis(self.group(POD_DP), self.axis_size(POD_DP),
                                self.axis_index(POD_DP))
        bind_axes(axes)


def _axis_groups(shape: Tuple[int, ...], rank: int):
    """Per axis, this rank's group and index on a row-major mesh of
    `shape` (the last axis fastest; an axis of size 1 gets a group of its
    one rank). Every rank creates every group, in the same order."""
    coords = []
    r = rank
    for n in reversed(shape):
        coords.append(r % n)
        r //= n
    coords = coords[::-1]
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups, index = {}, {}
    world = math.prod(shape)
    for i, n in enumerate(shape):
        index[i] = coords[i]
        if n == world:
            groups[i] = None          # the default group
            continue
        others = [j for j in range(len(shape)) if j != i]
        mine = None
        for rest in itertools.product(*(range(shape[j]) for j in others)):
            base = sum(c * strides[j] for c, j in zip(rest, others))
            ranks = [base + k * strides[i] for k in range(n)]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups[i] = mine
    return groups, index


def _flat_group(shape: Tuple[int, ...], rank: int):
    """On a (pod, data, model) mesh, this rank's group of the flattened
    (pod, data) axis: for each model index m the ranks (p * data + d) *
    model + m in pod-major order, the default group where model is 1.
    Every rank creates every group, in the same order."""
    pod, data, model = shape
    if model == 1:
        return None
    mine = None
    for m in range(model):
        ranks = [(p * data + d) * model + m for p in range(pod)
                 for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(shape, axes) -> Mesh:
    """A mesh of the given shape over axes from ("pod", "data", "model"),
    row-major over the ranks of the open process group (rank = d * model +
    m; (p * data + d) * model + m with a pod axis), with one process group
    per axis (and the flattened ("pod", "data") one), bound for the model
    code. Without a process group it describes shapes only."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    sizes = dict(zip(axes, shape))
    unknown = set(axes) - {"pod", "data", "model"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the engine knows "
                         f"pod, data and model")
    if "pod" in sizes and axes != ("pod", "data", "model"):
        raise ValueError(f"a pod mesh's axes are ('pod', 'data', 'model'), "
                         f"got {axes}")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axes, shape, {a: None for a in axes})
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {sizes} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    groups, index = _axis_groups(shape, dist.get_rank())
    groups = {a: groups[i] for i, a in enumerate(axes)}
    index = {a: index[i] for i, a in enumerate(axes)}
    if "pod" in sizes:
        groups[POD_DP] = _flat_group(shape, dist.get_rank())
        index[POD_DP] = index["pod"] * sizes["data"] + index["data"]
    mesh = Mesh(axes, shape, groups, index)
    mesh.bind()
    return mesh


def make_host_mesh(data: int = 1, model: int = 1,
                   pod: Optional[int] = None) -> Mesh:
    """The reference's small test mesh: (data, model) over the ranks
    run_ranks started (the reference's host CPU devices), rank =
    d * model + m; with `pod`, (pod, data, model)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: 16 x 16 = 256 ranks a pod, 2 x 16
    x 16 = 512 across two pods. Shapes only without a process group; over
    one of 256 (512) ranks, its groups (the dry run's fake group)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))
