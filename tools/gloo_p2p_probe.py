"""Does gloo's point-to-point send / recv take CUDA tensors? Two ranks on
cuda:0 over gloo (launch/mesh.py) exchange one CUDA tensor with
dist.isend / dist.irecv, without staging, and report what arrived.

The port's point-to-point collectives (core/collectives.py ring_shift and
reduce_scatter) stage CUDA tensors through pinned host buffers under
gloo; this probe records why. Run on a machine with a card:
`python3 tools/gloo_p2p_probe.py`. Prints one JSON line: `ok` true when
the received tensor equals the sent one, or the error a rank raised (a
rank that crashes shows as its exit code).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def exchange(rank, n, dev):
    import torch
    import torch.distributed as dist
    sent = torch.arange(1 << 16, dtype=torch.int32, device=dev) + rank
    got = torch.full_like(sent, -1)
    reqs = [dist.isend(sent, (rank + 1) % n), dist.irecv(got, (rank - 1) % n)]
    for r in reqs:
        r.wait()
    torch.cuda.synchronize()
    want = (torch.arange(1 << 16, dtype=torch.int32, device=dev)
            + (rank - 1) % n)
    return bool(torch.equal(got, want))


def main() -> int:
    import torch
    from repro_torch.launch.mesh import run_ranks
    if not torch.cuda.is_available():
        print("gloo_p2p_probe: needs a card", file=sys.stderr)
        return 2
    try:
        ok = run_ranks(exchange, 2, backend="gloo", device="cuda",
                       timeout=120)
        out = {"ok": all(ok), "ranks": ok}
    except (RuntimeError, TimeoutError) as e:
        out = {"ok": False, "error": str(e)[-1500:]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
