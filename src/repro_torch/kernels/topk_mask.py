"""Block-local top-k mask: the wrapper of the CUDA kernel in
csrc/topk_mask.cu and its plain-torch versions (ref.topk_mask_ref, and
topk_mask_rounds_plain, the kernel's own scheme written as tensor ops).

Each 512-wide row of the flat input keeps its entries with |x| at or
above the threshold that 24 bisection halvings of [0, row max] find for
k. `topk_mask_flat` takes any contiguous f32 or bf16 tensor, the last
row zero-padded as the reference pads it (kernels/ops.py:82), in one
launch and no copies; `topk_mask` is its (R, 512) f32 call. Both count
their launches in `topk_mask.launches`. The same routing as
kernels/qsgd.py: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or the wrapper raises."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import (_check, _launch_args, _on_card,
                                      kernel_bytes)

BLOCK_C = 512
ITERS = ref.TOPK_ITERS
#: the element types the kernel takes, by their size in bytes
KERNEL_DTYPES = {torch.float32: 4, torch.bfloat16: 2}
#: a row's count is summed in a 10-bit field of a 32-bit word
#: (csrc/topk_mask.cu kFieldBits)
FIELD_BITS = 10
#: entries of [lo, hi) the kernel lists once few are left, and the row max
#: (the bits of 2^126) from which it counts the whole row at every step
#: (csrc/topk_mask.cu kListMax, kListBelow)
LIST_MAX, LIST_BELOW = 64, 0x7e800000


def _tile(x: torch.Tensor):
    """Any-shape x -> ((rows, BLOCK_C) zero-padded rows of the flat input,
    d): the reference's tiles of blockwise top-k, less its row padding to
    a multiple of 8 (rows of zeros keep nothing)."""
    d = x.numel()
    rows = -(-d // BLOCK_C)
    xt = F.pad(x.reshape(-1), (0, rows * BLOCK_C - d))
    return xt.reshape(rows, BLOCK_C).contiguous(), d


def _untile(xt: torch.Tensor, d: int, shape) -> torch.Tensor:
    return xt.reshape(-1)[:d].reshape(shape)


def topk_mask_plain(x, k: int) -> torch.Tensor:
    return ref.topk_mask_ref(x, k)


def topk_mask_flat_plain(x, k: int) -> torch.Tensor:
    """topk_mask_flat as tensor ops: x in f32, tiled, masked, cut back to
    its shape and cast to its dtype."""
    xt, d = _tile(x.to(torch.float32))
    return _untile(ref.topk_mask_ref(xt, k), d, x.shape).to(x.dtype)


def _midpoint(lo, hi):
    return 0.5 * (lo + hi)                       # f32, rounded twice


def _warp_counts(lanes, ts):
    """The warp's counts of lanes >= each t of ts (<= 2), as the kernel
    sums them: each lane's counts in 10-bit fields of a word, the words
    summed over the 32 lanes modulo 2^32. lanes (32, n) f32."""
    packed = sum((lanes >= t).sum(-1) << (FIELD_BITS * f)
                 for f, t in enumerate(ts))
    word = int(packed.sum()) & 0xffffffff
    return [(word >> (FIELD_BITS * f)) & ((1 << FIELD_BITS) - 1)
            for f in range(len(ts))]


def _bisect(lanes, lo, hi, k):
    """One bisection step: its threshold counted over lanes against k."""
    t = _midpoint(lo, hi)
    return (t, hi) if _warp_counts(lanes, [t])[0] > k else (lo, t)


def _row_threshold(mag, k: int):
    """csrc/topk_mask.cu threshold on one row's magnitudes (512,) f32 ->
    lo (a 0-d f32 tensor)."""
    lanes = mag.reshape(32, BLOCK_C // 32)
    bits = mag.view(torch.int32).max()
    hi, lo = bits.view(torch.float32), torch.zeros((), dtype=torch.float32)
    k = max(k, -1)
    if int(bits) >= LIST_BELOW:
        for _ in range(ITERS):
            lo, hi = _bisect(lanes, lo, hi, k)
        return lo
    t0 = _midpoint(lo, hi)
    c0, at_hi = _warp_counts(lanes, [t0, hi])
    at_lo = BLOCK_C
    lo, hi, at_lo, at_hi = ((t0, hi, c0, at_hi) if c0 > k
                            else (lo, t0, at_lo, c0))
    step = 1
    while step < ITERS and at_lo - at_hi > LIST_MAX:
        t = _midpoint(lo, hi)
        c = _warp_counts(lanes, [t])[0]
        lo, hi, at_lo, at_hi = ((t, hi, c, at_hi) if c > k
                                else (lo, t, at_lo, c))
        step += 1
    if step == ITERS:
        return lo
    listed = mag[(mag >= lo) & (mag < hi)]
    assert listed.numel() == at_lo - at_hi <= LIST_MAX
    lanes = F.pad(listed, (0, LIST_MAX - listed.numel()),
                  value=float("nan")).reshape(2, 32).T
    for _ in range(step, ITERS):
        lo, hi = _bisect(lanes, lo, hi, k - at_hi)
    return lo


def topk_mask_rounds_plain(x, k: int) -> torch.Tensor:
    """ref.topk_mask_ref computed row by row as the kernel computes it
    (csrc/topk_mask.cu threshold): the row max as the largest bit pattern
    of |x|; the first step counting its threshold and the max at once;
    whole-row steps while more than LIST_MAX entries lie in [lo, hi);
    then those entries listed and the remaining steps counted on the list,
    offset by count(|x| >= hi); counts in 10-bit fields summed over the
    row's 32 lanes. x (R, 512) f32."""
    mag = x.abs()
    lo = torch.stack([_row_threshold(m, k) for m in mag])
    return torch.where(mag >= lo[:, None], x, 0.0)


def flat_output(x: torch.Tensor, k) -> torch.Tensor:
    """Check topk_mask_flat's input (f32 or bf16, contiguous, k an int32)
    and allocate its output."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x: the kernel takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not isinstance(k, int) or not -2**31 <= k < 2**31:
        raise ValueError(f"k must be an int32, got {k!r}")
    return torch.empty_like(x)


def _launch(x: torch.Tensor, out: torch.Tensor, k: int) -> torch.Tensor:
    d = x.numel()
    if d == 0 or not kernel_bytes(topk_mask, [x, out]):
        return out
    build.check(build.library("topk_mask").topk_mask_flat(
        x.data_ptr(), out.data_ptr(), d, k, KERNEL_DTYPES[x.dtype],
        *_launch_args(x.device)), "topk_mask")
    topk_mask.launches += 1
    return out


def topk_mask_flat(x, k: int) -> torch.Tensor:
    """Any contiguous f32 or bf16 x -> the same shape and dtype: each
    BLOCK_C-element row of the flat input keeps its top-k by magnitude
    (ties at the threshold keep more), the rest +0.0; the last row
    zero-padded. One launch."""
    if not _on_card(x):
        return topk_mask_flat_plain(x, k)
    return _launch(x, flat_output(x, k), k)


def topk_mask(x, k: int) -> torch.Tensor:
    """x (R, 512) f32 -> (R, 512) f32: each row's top-k by magnitude kept
    (ties at the threshold keep more), the rest 0. One launch."""
    if not _on_card(x):
        return topk_mask_plain(x, k)
    _check(x, "x", torch.float32, (*x.shape[:1], BLOCK_C))
    return _launch(x, flat_output(x, k), k)


topk_mask.launches = 0
