"""Times the selective-scan kernels (rows 6-7) on a CUDA card, for the
``nbss_tpu_torch`` package under a given checkout, so that two checkouts can be
compared in one run:

    python3 scripts/time_scan.py [ROOT] [N ...]   # ROOT: the checkout, default .; N: 16

Forward at OnlineSpatialNet's serving shape (M = 16 x 129, T = 251, D = 192)
and, with the saved states, at its training shape (M = 8 x 129), backward at
the training shape; bf16, CUDA events after warm-up (20 calls each), at each
state size N the checkout takes. Operands from a seeded generator, the same for
every checkout. Prints one JSON line with the card's name. Needs a CUDA card;
builds the checkout's kernels first."""

from __future__ import annotations

import json
import math
import os
import sys

M_SERVE, M_TRAIN, T, D = 16 * 129, 8 * 129, 251, 192


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sizes = [int(n) for n in sys.argv[2:]] or [16]
    sys.path.insert(0, root)
    import torch

    from nbss_tpu_torch.ops import ssm

    if not torch.cuda.is_available():
        print("time_scan: needs a CUDA card", file=sys.stderr)
        return 2

    def ms(fn, iters=20):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {"root": root, "device": torch.cuda.get_device_name(0), "times": []}
    for N in sizes:
        g = torch.Generator().manual_seed(N)
        bf = torch.bfloat16
        x = torch.randn(M_SERVE, T, D, generator=g)
        dt = torch.empty(M_SERVE, T, D).uniform_(math.log(1e-3), math.log(1e-1), generator=g).exp()
        A = -torch.arange(1.0, N + 1).expand(D, N).contiguous()
        Bm, Cm = torch.randn(M_SERVE, T, N, generator=g), torch.randn(M_SERVE, T, N, generator=g)
        Dp = 1 + 0.1 * torch.randn(D, generator=g)
        gy = torch.randn(M_TRAIN, T, D, generator=g)
        ins = [t.cuda() for t in (x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), Dp)]
        gy = gy.to(bf).cuda()
        train = [t[:M_TRAIN] if t.dim() == 3 else t for t in ins]
        fwd = ms(lambda: ssm.forward(*ins))
        fwd_saved = ms(lambda: ssm.forward(*train, boundaries=True))
        _, hb = ssm.forward(*train, boundaries=True)
        bwd = ms(lambda: ssm.backward(*train, hb, gy))
        out["times"].append({"N": N, "fwd_ms": fwd, "fwd_saved_ms_m1032": fwd_saved,
                             "bwd_ms": bwd})
        del ins, train, gy, hb
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
