"""Scan-aware HLO cost analysis (the JAX package's launch/hlo_cost.py),
and the port's counter over one rank's step.

The parser is the reference's, copied: `parse_hlo` and
`scan_scaled_costs` read the three roofline inputs off HLO text (such as
the text the reference's `dryrun --save-hlo` writes) with while-loop
trip-count scaling:

  flops            2·M·N·K over every `dot` op (matmul-dominated models;
                   elementwise flops are <1% and ignored — documented)
  hbm bytes        an HBM-traffic MODEL (not a measurement): dots count
                   lhs+rhs+result bytes (weight reads dominate); fusions,
                   dynamic-update-slices, gathers/scatters and collectives
                   count 2x their result. Copies/converts/reshapes are
                   EXCLUDED — XLA:CPU materializes loop-carry copies and
                   bf16->f32 promotions every iteration, which a TPU (with
                   native bf16 and in-place loop carries) would not.
  collective bytes per-op wire model from result shape + replica group
                   size (ring allreduce ~2x payload, all-gather ~received,
                   reduce-scatter ~(g-1)x result, all-to-all ~result)

Loop trip counts come from the integer constant in each while condition
computation (jax scans lower to counted loops); multiplicities propagate
through nested whiles / fusions / calls / conditionals.

The port compiles nothing, so it has no HLO of its own. `StepCost`, a
TorchDispatchMode, counts the same three inputs over one rank's step as it
runs (on meta tensors in a dry run, on the card in a real step), op by op
after autograd, with the reference's rules where they carry over:

  flops            2·M·N·K over every mm, bmm, addmm, baddbmm, mv, addmv
                   and dot, and every convolution and convolution backward
                   (2 x the output's entries x the input features a
                   filter sees, per computed gradient); nothing else.
                   Python loops run unrolled, so nothing is scaled.
  hbm bytes        eager torch does not fuse: each op dispatched on the
                   step's device (on meta or the card, not the host, where
                   the keys' arithmetic runs) reads its tensor inputs once
                   and writes its outputs once (a mutated argument is
                   written, not read; a broadcast's stride-0 dims count
                   once); views and
                   uninitialized allocations (empty*) are free. A
                   hand-written kernel counts each buffer it reads or
                   writes once (kernels/qsgd.py kernel_bytes). A collective
                   counts 2x its result, as in the reference; its own ops
                   count nothing more.
  collective bytes each collective as the reference HLO op it stands for
                   (core/collectives.py `observe`): all-gather, all-reduce
                   (the port's all_gather + rank-order sum, a psum),
                   reduce-scatter, collective-permute (the ring's shift),
                   with `_wire_bytes` of its result and its group's size.
                   That is the reference's op, not the port's traffic: the
                   port's all-reduce is an all_gather and a rank-order sum,
                   which receives (g - 1) x the result where a ring
                   all-reduce moves 2 (g - 1) / g x. `port_collectives`
                   holds what the port's collectives received instead
                   ({collective: bytes}, core/collectives.py's
                   recv_bytes; the metric reductions of gather_metrics,
                   a few bytes, are not among them).

Beside the counter, a tracker of live bytes stands in for
compiled.memory_analysis(): the storages an op returns are live until
they are freed (a weak reference to each); `memory_analysis()` gives
argument_size_in_bytes (the step's inputs), output_size_in_bytes (its
outputs) and temp_size_in_bytes: the peak of live storage during the step,
less the arguments.

On meta tensors the meta kernels run in Python and dominate a dry run's
time, so StepCost reuses the output shapes of an op it has seen with the
same input shapes, strides and arguments (any op that neither aliases nor
mutates its inputs: the shapes are a function of them).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import re
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import collectives as _collectives
from repro_torch.kernels import qsgd as _qsgd

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_NAME_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*")
_OPS = ("while|conditional|call|fusion|dot|convolution|custom-call|copy|"
        "convert|bitcast|broadcast|reshape|transpose|slice|dynamic-slice|"
        "dynamic-update-slice|concatenate|pad|reduce-window|reduce|select|"
        "compare|add|subtract|multiply|divide|maximum|minimum|exponential|"
        "tanh|rsqrt|sqrt|log|negate|sign|floor|ceil|and|or|not|xor|iota|"
        "rng-bit-generator|rng|constant|parameter|get-tuple-element|tuple|"
        "all-gather-start|all-gather-done|all-gather|all-reduce-start|"
        "all-reduce-done|all-reduce|reduce-scatter|all-to-all|"
        "collective-permute-start|collective-permute-done|"
        "collective-permute|partition-id|replica-id|scatter|gather|sort|"
        "clamp|power|abs|cosine|sine|is-finite|select-and-scatter|"
        "after-all|optimization-barrier|domain|shift-left|"
        "shift-right-logical|shift-right-arithmetic|map|atan2|tan|"
        "stochastic-convert|real|imag|complex|reverse|remainder|"
        "round-nearest-afz|round-nearest-even|cbrt|logistic|expm1|log1p|"
        "popcnt|clz|dynamic-reshape|triangular-solve|cholesky|fft|"
        "batch-norm-training|batch-norm-inference|batch-norm-grad|"
        "infeed|outfeed|send|recv|erf")
# first "  <op>(" occurrence after '=' is the real op (type strings and
# /*index=N*/ comments contain no parens)
_OP_RE = re.compile(r"=\s.*?\s(" + _OPS + r")\(")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_WHILE_RE = re.compile(r"condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_TOAPPLY_RE = re.compile(r"to_apply=%?([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}|"
                        r"true_computation=%?([\w.\-]+), "
                        r"false_computation=%?([\w.\-]+)")
_CONST_RE = re.compile(r"=\s*s32\[\]\s+constant\((\d+)\)")
# dot operand: optional inline type annotation + %name (newer HLO prints
# "dot(f32[128,128]{1,0} %lhs, f32[128,128]{1,0} %rhs)")
_DOT_ARG_RE = re.compile(
    r"(?:([a-z0-9]+\[[0-9,]*\](?:\{[0-9,]*\})?)\s+)?%([\w.\-]+)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops whose RESULT x2 counts as HBM traffic (TPU-relevant materializers)
_BYTES_OPS = {"fusion", "dynamic-update-slice", "dynamic-slice", "gather",
              "scatter", "reduce", "reduce-window", "sort", "concatenate",
              "pad", "rng-bit-generator", "custom-call", "slice",
              "select-and-scatter"}


def _shape_dims(shape_str: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt in _DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _numel(shape_str: str) -> int:
    n = 0
    for _, dims in _shape_dims(shape_str):
        m = 1
        for d in dims:
            m *= d
        n += m
    return n


@dataclasses.dataclass
class CompCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Optional[Dict[str, float]] = None
    children: Optional[List[Tuple[str, float]]] = None  # (name, times)


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # [G,S]<=[N] : G groups of size S
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    return default


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


def parse_hlo(text: str, default_group: int):
    """-> dict name -> CompCost, plus entry computation name."""
    comps: Dict[str, CompCost] = {}
    trip_hint: Dict[str, int] = {}   # cond computation -> trip count
    entry = None
    cur = None
    shapes: Dict[str, str] = {}

    for raw in text.splitlines():
        line = raw.rstrip()
        if not line or line.startswith(("HloModule", "  ROOT %tuple")):
            pass
        mc = _COMP_RE.match(line)
        if mc and line.endswith("{"):
            cur = mc.group(1)
            comps[cur] = CompCost(coll={k: 0.0 for k in COLLECTIVES},
                                  children=[])
            shapes = {}
            if line.startswith("ENTRY"):
                entry = cur
            continue
        if cur is None:
            continue
        if line.startswith("}"):
            cur = None
            continue
        mn = _NAME_RE.match(line)
        if not mn:
            continue
        mo = _OP_RE.search(line)
        if not mo:
            continue
        name, op = mn.group(1), mo.group(1)
        rtype = line[mn.end():mo.start(1) - 1].strip()
        shapes[name] = rtype
        cc = comps[cur]

        # integer constants (trip-count hints for cond computations)
        m = _CONST_RE.search(line)
        if m:
            trip_hint[cur] = max(trip_hint.get(cur, 1), int(m.group(1)))

        # child computations
        if op == "while":
            mw = _WHILE_RE.search(line)
            if mw:
                cc.children.append(("__while__:" + mw.group(1) + ":" +
                                    mw.group(2), 1.0))
        elif op in ("fusion", "call"):
            mcalls = _CALLS_RE.search(line) or _TOAPPLY_RE.search(line)
            if mcalls:
                cc.children.append((mcalls.group(1), 1.0))
        elif op == "conditional":
            mb = _BRANCH_RE.search(line)
            if mb:
                names = (mb.group(1).split(",") if mb.group(1)
                         else [mb.group(2), mb.group(3)])
                for nm in names:
                    nm = nm.strip().lstrip("%")
                    if nm:
                        cc.children.append((nm, 1.0))

        # flops: dot ops (+ operand-byte traffic for the memory model)
        if op == "dot":
            argstr = line.split("dot(", 1)[1].split(")", 1)[0]
            args = _DOT_ARG_RE.findall(argstr)
            # inline type annotation wins; fall back to the operand's
            # definition earlier in this computation
            lhs = (args[0][0] or shapes.get(args[0][1])) if args else None
            rhs = (args[1][0] or shapes.get(args[1][1])) \
                if len(args) > 1 else None
            mcd = _CONTRACT_RE.search(line)
            k = 1
            opbytes = 0
            if lhs:
                opbytes += _shape_bytes(lhs)
                if mcd:
                    dims = _shape_dims(lhs)
                    if dims:
                        ldims = dims[0][1]
                        for ci in mcd.group(1).split(","):
                            if ci != "" and int(ci) < len(ldims):
                                k *= ldims[int(ci)]
            if rhs:
                opbytes += _shape_bytes(rhs)
            cc.flops += 2.0 * _numel(rtype) * k
            cc.bytes += opbytes + _shape_bytes(rtype)

        # hbm bytes model
        base_op = op.replace("-start", "").replace("-done", "")
        if op in _BYTES_OPS and not op.endswith("-done"):
            cc.bytes += 2.0 * _shape_bytes(rtype)
        elif base_op in COLLECTIVES and not op.endswith("-done"):
            cc.bytes += 2.0 * _shape_bytes(rtype)

        # collectives
        if base_op in COLLECTIVES and not op.endswith("-done"):
            g = _group_size(line, default_group)
            cc.coll[base_op] += _wire_bytes(base_op, _shape_bytes(rtype), g)

    return comps, trip_hint, entry


def scan_scaled_costs(text: str, default_group: int):
    """Returns dict(flops=..., bytes=..., collectives={kind: bytes}) with
    while-loop trip scaling. All values are PER DEVICE."""
    comps, trip_hint, entry = parse_hlo(text, default_group)
    if entry is None:
        return {"flops": 0.0, "bytes": 0.0,
                "collectives": {k: 0.0 for k in COLLECTIVES}}

    memo: Dict[str, Tuple[float, float, Dict[str, float]]] = {}
    stack = set()

    def total(name: str):
        if name in memo:
            return memo[name]
        if name not in comps or name in stack:
            return 0.0, 0.0, {k: 0.0 for k in COLLECTIVES}
        stack.add(name)
        c = comps[name]
        f, b = c.flops, c.bytes
        coll = dict(c.coll)
        for child, times in c.children:
            if child.startswith("__while__:"):
                _, cond, body = child.split(":")
                trip = trip_hint.get(cond, 1)
                for sub in (cond, body):
                    sf, sb, sc = total(sub)
                    f += sf * trip
                    b += sb * trip
                    for k in coll:
                        coll[k] += sc[k] * trip
            else:
                sf, sb, sc = total(child)
                f += sf * times
                b += sb * times
                for k in coll:
                    coll[k] += sc[k] * times
        stack.discard(name)
        memo[name] = (f, b, coll)
        return memo[name]

    f, b, coll = total(entry)
    return {"flops": f, "bytes": b, "collectives": coll}


# ---- the port's counter over one rank's step ---------------------------------

_aten = torch.ops.aten


def _mm(a, b):
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b):
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv(inp, weight, out, transposed) -> float:
    """2 x the entries one side produces x the input features a filter
    sees: out entries x (C_in / groups) x kernel (x input entries x
    (C_out / groups) x kernel for a transposed convolution)."""
    per = 1
    for s in weight.shape[1:]:
        per *= s
    return 2.0 * (inp.numel() if transposed else out.numel()) * per


_DOT_FLOPS = {
    _aten.mm: lambda a, o: _mm(a[0], a[1]),
    _aten.addmm: lambda a, o: _mm(a[1], a[2]),
    _aten.bmm: lambda a, o: _bmm(a[0], a[1]),
    _aten.baddbmm: lambda a, o: _bmm(a[1], a[2]),
    _aten.mv: lambda a, o: 2.0 * a[0].shape[0] * a[0].shape[1],
    _aten.addmv: lambda a, o: 2.0 * a[1].shape[0] * a[1].shape[1],
    _aten.dot: lambda a, o: 2.0 * a[0].shape[0],
    _aten.convolution: lambda a, o: _conv(a[0], a[1], o, a[6]),
    # (grad_output, input, weight, ..., transposed = [7], ...,
    # output_mask = [10]): each computed input / weight gradient costs
    # the forward's flops
    _aten.convolution_backward: lambda a, o: (
        _conv(a[1], a[2], a[0], a[7]) * (bool(a[10][0]) + bool(a[10][1]))),
}

#: allocations whose storage is not written
_UNWRITTEN = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided,
              _aten.empty_permuted}


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor covers (a broadcast's
    stride-0 dims once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                yield v


class _Op:
    """What StepCost needs of an op overload, worked out once."""

    def __init__(self, func):
        schema = func._schema
        self.packet = func.overloadpacket
        self.name = str(self.packet)
        self.flops = _DOT_FLOPS.get(self.packet)
        aliases = (any(r.alias_info is not None for r in schema.returns)
                   or func.is_view)
        writes = any(a.alias_info is not None and a.alias_info.is_write
                     for a in schema.arguments)
        self.names = tuple(a.name for a in schema.arguments)
        self.free = aliases and not writes or self.packet in _UNWRITTEN
        # a pure function of its inputs' metadata: reusable on meta
        self.memo = not aliases and not writes and func.namespace == "aten"
        # reaches the mode whole where autograd is off (inference): its
        # decomposition is what runs
        self.composite = self.flops is None and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")


def _key(xs):
    out = []
    for a in xs:
        if isinstance(a, torch.Tensor):
            out.append((a.shape, a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            out.append(_key(a))
        else:
            out.append(a)
    return tuple(out)


def _all_meta(args, kwargs) -> bool:
    """True when an op's arguments hold a tensor and every one is a meta
    tensor."""
    seen = False
    for a in itertools.chain(args, kwargs.values()):
        for t in _tensors(a):
            if not t.is_meta:
                return False
            seen = True
    return seen


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _flat_out(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _received() -> Dict[str, int]:
    """{port collective: the bytes it has received} (the counters of
    core/collectives.py)."""
    return {c: int(_collectives.counts(c)["recv_bytes"])
            for c in _collectives.COLLECTIVES}


class StepCost(TorchDispatchMode):
    """Counts one rank's step (the module docstring's rules) while it runs:
    `flops`, `bytes` (the HBM model), `collectives` ({kind: wire bytes},
    the reference's COLLECTIVES) and, per hand-written kernel, its counted
    calls and their bytes (`kernels`, `kernel_bytes`) and the bytes the
    port's own collectives received (`port_collectives`); tracks live
    bytes for `memory_analysis()`.

        cost = StepCost()
        cost.arguments(params, opt_state, batch)
        with cost:
            out = step(params, opt_state, batch, 0)
        cost.outputs(out)

    The step's device is its arguments' (without them, any but the CPU):
    an op counts when it touches a tensor there, a storage is live bytes
    when it lies there. So the host's key arithmetic of a step on meta
    tensors or on the card counts nothing, while a step that runs on the
    CPU counts every op. `costs()` is scan_scaled_costs' dict; `ops`
    counts the counted ops by name (views are not counted)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.port_collectives: Dict[str, int] = {}
        self._recv0: Dict[str, int] = {}
        self.kernels: Dict[str, int] = collections.Counter()
        self.kernel_bytes: Dict[str, int] = collections.Counter()
        self.ops: Dict[str, int] = collections.Counter()
        self._info: Dict[object, _Op] = {}
        self._memo: Dict[tuple, tuple] = {}
        self._cmemo: Dict[tuple, tuple] = {}
        self._args: set = set()
        self._refs: Dict[int, object] = {}
        self._device: Optional[str] = None
        self.argument_bytes = 0
        self.output_bytes = 0
        self.live = 0
        self.peak = 0

    # ---- the observers' ends (core/collectives.py, kernels/qsgd.py) -----
    def collective(self, kind: str, result_bytes: int, group_size: int):
        self.collectives[kind] += _wire_bytes(kind, result_bytes, group_size)
        if group_size > 1:        # one rank's collective moves nothing
            self.bytes += 2.0 * result_bytes

    def kernel(self, name: str, nbytes: int):
        if not _collectives.inside():
            self.bytes += nbytes
            self.kernels[name] += 1
            self.kernel_bytes[name] += nbytes

    def __enter__(self):
        if _collectives._observer is not None or _qsgd._observer is not None:
            raise RuntimeError("another StepCost is counting")
        _collectives._observer = _qsgd._observer = self
        self._recv0 = _received()
        return super().__enter__()

    def __exit__(self, *exc):
        _collectives._observer = _qsgd._observer = None
        self.port_collectives = {k: v - self._recv0[k]
                                 for k, v in _received().items()}
        return super().__exit__(*exc)

    def _counted(self, t: torch.Tensor) -> bool:
        """t lies on the step's device."""
        return (t.device.type == self._device if self._device
                else t.device.type != "cpu")

    # ---- memory -----------------------------------------------------------
    def _storages(self, tree):
        return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _leaves(tree) if self._counted(t)}

    def arguments(self, *trees) -> None:
        """Register the step's inputs (live before it starts); their device
        is the step's (meta placeholders of a step on the card hold no
        memory, and its host ops no HBM traffic)."""
        self._device = next((t.device.type for t in _leaves(trees)), None)
        st = self._storages(trees)
        self._args.update(st)
        self.argument_bytes = sum(st.values())

    def outputs(self, tree) -> None:
        """Register the step's outputs and stop tracking."""
        self.output_bytes = sum(self._storages(tree).values())
        self._refs.clear()

    def _freed(self, key: int, nbytes: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            if not self._counted(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs or key in self._args:
                continue
            nb = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, k=key, n=nb: self._freed(k, n))
            self.live += nb
            if self.live > self.peak:
                self.peak = self.live

    def memory_analysis(self) -> Dict[str, float]:
        """compiled.memory_analysis()'s sizes for the traced step."""
        return {"argument_size_in_bytes": float(self.argument_bytes),
                "output_size_in_bytes": float(self.output_bytes),
                "temp_size_in_bytes": float(self.peak)}

    # ---- the ops ----------------------------------------------------------
    def _cost(self, op: _Op, args, kwargs, outs):
        """(flops, bytes) of one op, or None for an op off the step's
        device."""
        vals = list(args) + [kwargs.get(n) for n in op.names[len(args):]]
        if not (outs and self._counted(outs[0])) and not any(
                self._counted(t) for v in vals for t in _tensors(v)):
            return None
        flops = 0.0 if op.flops is None else op.flops(
            vals, outs[0] if outs else None)
        if op.free:
            return flops, 0
        seen, nbytes = set(), 0
        for v in vals:
            for t in _tensors(v):
                if id(t) in seen or not self._counted(t):
                    continue
                seen.add(id(t))
                nbytes += _distinct_bytes(t)   # read, or written in place
        for t in outs:
            if id(t) not in seen and self._counted(t):
                seen.add(id(t))
                nbytes += _distinct_bytes(t)
        return flops, nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self._info.get(func)
        if op is None:
            op = self._info[func] = _Op(func)
        if op.composite:
            out = self._decompose(func, op, args, kwargs)
            if out is not NotImplemented:
                return out
        cost = None
        if op.memo and _all_meta(args, kwargs):
            key = (func, _key(args), _key(kwargs.items()) if kwargs else ())
            hit = self._memo.get(key)
            if hit is None:
                out = func(*args, **kwargs)
                outs = _flat_out(out)
                cost = self._cost(op, args, kwargs, outs)
                seq = isinstance(out, (list, tuple))
                if len(outs) == (len(out) if seq else 1):
                    self._memo[key] = (seq, type(out), [
                        (t.shape, t.stride(), t.dtype) for t in outs], cost)
            else:
                seq, typ, metas, cost = hit
                outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in metas]
                out = typ(outs) if seq else outs[0]
        else:
            out = func(*args, **kwargs)
            outs = _flat_out(out)
            if not (op.free and op.flops is None):
                cost = self._cost(op, args, kwargs, outs)
        if cost is not None and not _collectives.inside():
            if not op.free:
                self.ops[op.name] += 1
            self.flops += cost[0]
            self.bytes += cost[1]
        self._track(outs)
        return out

    def _decompose(self, func, op: _Op, args, kwargs):
        """Run a composite op's decomposition through the mode. On meta its
        whole effect (costs, counted ops, the transient peak above the live
        bytes it started from, its outputs' shapes) is a function of its
        inputs' metadata, and is reused."""
        key = None
        # (inside a collective nothing is counted: no deltas to keep)
        if op.memo and not _collectives.inside() and _all_meta(args,
                                                               kwargs):
            key = (func, _key(args), _key(kwargs.items()) if kwargs else ())
            hit = self._cmemo.get(key)
            if hit is not None:
                seq, typ, metas, flops, nbytes, ops, rise = hit
                self.flops += flops
                self.bytes += nbytes
                self.ops.update(ops)
                self.peak = max(self.peak, self.live + rise)
                outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in metas]
                self._track(outs)
                return typ(outs) if seq else outs[0]
        f0, b0, ops0 = self.flops, self.bytes, dict(self.ops)
        live0, peak0 = self.live, self.peak
        self.peak = self.live
        super().__enter__()
        try:
            out = func.decompose(*args, **kwargs)
        finally:
            super().__exit__(None, None, None)
            rise = self.peak - live0
            self.peak = max(peak0, self.peak)
        outs = _flat_out(out) if out is not NotImplemented else []
        seq = isinstance(out, (list, tuple))
        if key is not None and outs and \
                len(outs) == (len(out) if seq else 1):
            ops = {k: v - ops0.get(k, 0) for k, v in self.ops.items()
                   if v != ops0.get(k, 0)}
            self._cmemo[key] = (seq, type(out), [
                (t.shape, t.stride(), t.dtype) for t in outs],
                self.flops - f0, self.bytes - b0, ops, rise)
        return out

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here runs under torch.compile: no dynamo guard a dispatch
        return False

    def costs(self) -> Dict[str, object]:
        """scan_scaled_costs' dict: per-device flops, bytes, collectives."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives)}

