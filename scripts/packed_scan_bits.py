#!/usr/bin/env python3
"""Hold the packed kernel's outputs of two checkouts against each other, bit
for bit, on one CUDA card.

    python3 scripts/packed_scan_bits.py save OUT.pt     # in each checkout
    python3 scripts/packed_scan_bits.py compare A.pt B.pt

``save`` runs ``packed_scan_topk`` of the checkout it belongs to on
chip_smoke.py's seeded synthetic segments (all four dequant kinds, segment
lengths 40 / 21 / 9 / 7) at N=100,000, Q=256 and N=1,000, Q=65: L2, IP and
NIP, k=10 and 100, bf16 and f32, dense and gather (every third tile), and
saves the 48 results.  ``compare`` exits non-zero unless two saved sets are
equal bit for bit.  A change that only moves the kernel's code must pass.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def save(path: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_scan_bits: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vq_tpu_torch.kernels import packed_scan as pk

    dev = torch.device("cuda", 0)
    out = {}
    for n, nq in ((100_000, 256), (1000, 65)):
        syn = cs.synthetic_packed(torch, dev, n, nq, seed=9)
        nb = syn["factors"].shape[1] // 512
        mask = (torch.arange(nb, device=dev) % 3 == 0).to(torch.int32)
        for kind in ("l2", "ip", "nip"):
            for k in (10, 100):
                for bf16 in (True, False):
                    a = {**syn, "metric_kind": kind, "k": k, "use_bf16": bf16}
                    tag = f"N={n} {kind} k={k} bf16={bf16}"
                    out[tag] = [t.cpu() for t in pk.packed_scan_topk(**a)]
                    out[tag + " gather"] = [t.cpu() for t in
                                            pk.packed_scan_topk(**a, tile_mask=mask)]
    torch.save(out, path)
    print(f"saved {len(out)} packed_scan_topk results to {path}", flush=True)
    return 0


def compare(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    differ = sorted(t for t in a.keys() | b.keys()
                    if t not in a or t not in b or len(a[t]) != len(b[t])
                    or not all(torch.equal(x, y) for x, y in zip(a[t], b[t])))
    print(f"{len(a)} / {len(b)} results; differing: {differ or 'none'}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        sys.exit(save(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
