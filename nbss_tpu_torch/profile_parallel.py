"""Data-parallel training of SpatialNet-small on the card(s): the check and the rate.

    python3 -m nbss_tpu_torch.profile_parallel [--ranks N] [--backend nccl|gloo]
        [--steps S]

Starts N ranks (``parallel.launch``; NCCL with one card a rank when there
are N cards, or N ranks over gloo sharing card 0 with ``--backend gloo``)
that train SpatialNet-small (8 layers, H=96, 4 heads; bf16 compute, float32
parameters; Adam 1e-3, clip 5, neg-SI-SDR with PIT; seeded weights) on one
fixed global batch of 8 ``SyntheticDataset`` items of 6 channels x 4 s,
each rank on its 8/N contiguous rows, through ``Trainer.train_step``. Each
rank counts rows 1-2's launches over the S steps (8 + 8 tensor-core ones a
step), the global loss is averaged over the ranks, and the ranks' parameters
are compared by a crc32 of their bytes at the end; then the rate, in
audio-seconds trained per second, is timed over S more steps (``rate_steps``)
after two warm-up steps. With ``grads=True`` a rank first takes one float32 step
(CUDA-core kernels, no clipping) and rank 0 returns the all-reduced
gradient. Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
import zlib
from typing import Optional

B, CHANNELS, SECONDS, FS, SEED = 8, 6, 4.0, 8000, 2
SPATIALNET_SMALL = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                        num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                        num_freqs=129, full_share=0)


def global_batch():
    """The fixed global batch: ``SyntheticDataset`` items 0-7 (host arrays)."""
    import numpy as np

    from nbss_tpu_torch.data.synthetic import SyntheticDataset

    data = SyntheticDataset(num_items=B, num_channels=CHANNELS, sample_rate=FS,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(B)]
    return (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
            [it[2] for it in items])


def module(dtype, device):
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.train.module import TrainModule

    return TrainModule(arch=SpatialNet(**SPATIALNET_SMALL, dtype=dtype, device=device),
                       channels=tuple(range(CHANNELS)), stft=STFT(n_fft=256, n_hop=128),
                       norm=Norm(mode="frequency"))


def rank_run(steps: int, grads: bool, rate_steps: int) -> dict:
    """One rank's part (see the module docstring); ``steps`` 0 times the
    rate only."""
    import torch

    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.parallel import current_mesh
    from nbss_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, dev = current_mesh(), torch.device("cuda", torch.cuda.current_device())
    batch = global_batch()
    out = {"rank": mesh.rank, "size": mesh.size}
    if grads:
        trainer = Trainer(module(None, dev), gradient_clip_val=None, seed=SEED, device=dev)
        trainer.init()
        trainer.train_step(batch)
        if mesh.is_main:
            out["grads"] = {n: p.grad.detach().cpu() for n, p in trainer.arch.named_parameters()}
        del trainer
        torch.cuda.empty_cache()

    trainer = Trainer(module(torch.bfloat16, dev), gradient_clip_val=5.0, seed=SEED, device=dev)
    trainer.init()
    if steps:
        ab.tc_launches = ab.bwd_tc_launches = ab.launches = ab.bwd_launches = 0
        losses = [float(mesh.all_mean(trainer.train_step(batch))) for _ in range(steps)]
        torch.cuda.synchronize()
        out.update(losses=losses, launches=(ab.launches, ab.tc_launches, ab.bwd_launches,
                                            ab.bwd_tc_launches))
        flat = torch.cat([p.detach().reshape(-1) for p in trainer.arch.parameters()]).cpu()
        out["params_crc32"] = zlib.crc32(flat.numpy().tobytes())

    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(rate_steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    mesh.barrier()
    out["audio_s_per_s"] = rate_steps * B * SECONDS / (time.perf_counter() - t0)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def run(ranks: int, backend: str = "nccl", steps: int = 10, grads: bool = False,
        rate_steps: int = 10, devices: Optional[list] = None, timeout: float = 600) -> list:
    """``rank_run`` in ``ranks`` new ranks; their results in rank order.
    ``devices`` defaults to one card a rank (NCCL) or card 0 for every rank
    (gloo)."""
    from nbss_tpu_torch.ops import _build
    from nbss_tpu_torch.parallel import launch

    _build.build()  # once, before the ranks start
    if devices is None:
        devices = [f"cuda:{r}" if backend == "nccl" else "cuda:0" for r in range(ranks)]
    return launch(rank_run, (steps, grads, rate_steps), ranks, backend, devices,
                  timeout=timeout)


def main() -> int:
    import argparse

    import torch

    from nbss_tpu_torch.parallel.mesh import stop_fork_server

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=None, help="every card unless given")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_parallel: needs a CUDA card", file=sys.stderr)
        return 2
    ranks = args.ranks or torch.cuda.device_count()
    res = run(ranks, args.backend, args.steps)
    stop_fork_server()
    print(json.dumps({"ranks": ranks, "backend": args.backend,
                      "name": torch.cuda.get_device_name(0),
                      **{k: v for k, v in res[0].items() if k != "rank"},
                      "params_crc32_all": [r["params_crc32"] for r in res]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
