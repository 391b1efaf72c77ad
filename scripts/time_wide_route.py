"""Times the bf16 wide route of the attention block (rows 1-2 at H = 192, and at
H = 96 past 256 frames) on a CUDA card, for the ``nbss_tpu_torch`` package under a
given checkout, so that two checkouts can be compared in one run:

    python3 scripts/time_wide_route.py [ROOT]      # ROOT: the checkout, default .

Forward and backward, CUDA events after warm-up (10 and 5 calls), at
SpatialNet-large's serving / training shapes (M = 2064 / 1032, T = 251, H = 192,
4 heads), at whole 16-s recordings (M = 516, T = 1001, H = 192 and 96) and at
NBC2-large's two heads. Operands from a seeded generator, the same for every
checkout. Prints one JSON line with the card's name. Needs a CUDA card; builds
the checkout's kernels first."""

from __future__ import annotations

import json
import math
import os
import sys

SHAPES = ((2064, 1032, 251, 192, 4), (516, 516, 1001, 192, 4), (516, 516, 1001, 96, 4),
          (2064, 1032, 251, 192, 2))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    import torch

    from nbss_tpu_torch.ops import attention_block as ab

    if not torch.cuda.is_available():
        print("time_wide_route: needs a CUDA card", file=sys.stderr)
        return 2

    def ms(fn, iters):
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
    for M, Mb, T, H, nh in SHAPES:
        g = torch.Generator().manual_seed(H + nh)
        w_in, w_out = (torch.randn(n, H, generator=g) / math.sqrt(H) for n in (3 * H, H))
        b_in, b_out = 0.1 * torch.randn(3 * H, generator=g), 0.1 * torch.randn(H, generator=g)
        ln_w, ln_b = 1 + 0.1 * torch.randn(H, generator=g), 0.1 * torch.randn(H, generator=g)
        ln, A, Wvo, c, eps = ab.fold_weights(ln_w, ln_b, w_in, b_in, w_out, b_out, nh)
        ln, A, Wvo, c = (t.cuda() for t in (ln, A, Wvo, c))
        x = torch.randn(M, T, H, generator=g).cuda().to(torch.bfloat16)
        gr = torch.randn(Mb, T, H, generator=g).cuda().to(torch.bfloat16)
        with torch.no_grad():
            fwd = ms(lambda: ab.attention_block(x, ln, A, Wvo, c, eps, nh), 10)
        bwd = ms(lambda: ab.backward(x[:Mb], ln, A, Wvo, gr, eps, nh), 5)
        out["times"].append({"M": M, "M_bwd": Mb, "T": T, "H": H, "nh": nh, "fwd_ms": fwd,
                             "bwd_ms": bwd})
        del x, gr
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
