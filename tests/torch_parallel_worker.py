"""Rank functions of tests/test_torch_parallel.py, run in spawned gloo ranks
by ``nbss_tpu_torch.parallel.launch``. Imports torch and the port only (a
rank imports this module by name), so a rank starts without JAX.

The tiny SpatialNet is the one of tests/multihost_worker.py: 1 layer, H 16,
2 channels, 1 s at 8 kHz, STFT 256/128, neg-SI-SDR with PIT.
"""

import json
import os

import numpy as np
import torch

KW = dict(dim_input=4, dim_output=4, num_layers=1, dim_hidden=16, dim_ffn=32, num_heads=2,
          kernel_size=(3, 3), conv_groups=(2, 2), dim_squeeze=4, num_freqs=129, full_share=0)
GLOBAL_BATCH = 8
STEPS = 2


def make_module(state_dict=None):
    from nbss_tpu_torch.io import Loss, Norm, STFT
    from nbss_tpu_torch.models import SpatialNet
    from nbss_tpu_torch.train.module import TrainModule

    net = SpatialNet(**KW, fused_block=False, device="cpu")
    if state_dict is not None:
        net.load_state_dict(state_dict)
    return TrainModule(arch=net, channels=(0, 1), ref_channel=0, stft=STFT(n_fft=256, n_hop=128),
                       norm=Norm(mode="frequency"), loss=Loss(name="neg_si_sdr", pit=True))


def make_trainer(state_dict=None, mesh=None, ckpt_dir=None):
    from nbss_tpu_torch.train.loop import Trainer

    trainer = Trainer(make_module(), lr_scheduler=None, seed=7, device="cpu", mesh=mesh,
                      ckpt_dir=ckpt_dir)
    trainer.init()
    if state_dict is not None:
        trainer.arch.load_state_dict(state_dict)
    return trainer


def batches(n_items: int, batch: int, seed: int):
    """Host batches (x, ys, paras) of SyntheticDataset items 0..n_items-1."""
    from nbss_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_items=n_items, num_channels=2, audio_time_len=1.0)
    items = [ds[(i, seed + i)] for i in range(n_items)]
    return [(np.stack([it[0] for it in items[a:a + batch]]),
             np.stack([it[1] for it in items[a:a + batch]]),
             [it[2] for it in items[a:a + batch]])
            for a in range(0, n_items, batch)]


def flat(tensors) -> np.ndarray:
    return np.concatenate([t.detach().reshape(-1).numpy() for t in tensors])


def train_and_validate(trainer, mesh):
    """STEPS train steps on the global batches and a validation over 5 items
    in batches of 2 (the last one ragged): the per-step global losses, the
    clipped gradient of step 1, the parameters after STEPS steps and the
    validation logs."""
    train = batches(GLOBAL_BATCH * STEPS, GLOBAL_BATCH, seed=11)
    losses, grads = [], None
    for i, b in enumerate(train):
        losses.append(float(mesh.all_mean(trainer.train_step(b))))
        if i == 0:
            grads = flat(p.grad for p in trainer.arch.parameters())
    logs = trainer.validate(batches(5, 2, seed=40))
    return {"losses": losses, "grads": grads,
            "params": flat(trainer.arch.parameters()), "val": logs}


def dp_rank(state_path: str, out_dir: str):
    """One rank of the 2-rank run: train, validate, the replicated-batch check,
    and the rows each rank's loaders take."""
    from nbss_tpu_torch.data.synthetic import SyntheticDataModule
    from nbss_tpu_torch.parallel import current_mesh
    from nbss_tpu_torch.parallel.mesh import _assert_same_across_processes

    mesh = current_mesh()
    trainer = make_trainer(torch.load(state_path), mesh)
    out = train_and_validate(trainer, mesh)
    try:
        _assert_same_across_processes(mesh, np.full(3, mesh.rank, np.float32))
        out["crc_raised"] = False
    except ValueError:
        out["crc_raised"] = True
    dm = SyntheticDataModule(num_items=12, num_channels=2, audio_time_len=0.01,
                             batch_size=(4, 3), seeds=(1, 2, 3, 3), num_workers=2)
    out["train_items"] = [[p["index"] for p in b[2]] for b in dm.train_dataloader(0)]
    out["val_items"] = [([p["index"] for p in b[2]], b.replicated) for b in dm.val_dataloader()]
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"),
             **{k: v for k, v in out.items() if k in ("losses", "grads", "params")})
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({k: v for k, v in out.items() if k not in ("grads", "params")}, f)
    return mesh.rank


def host_rank(out_dir: str):
    """One rank of a two-host run: the items its train loader takes, then
    ``run_test`` over the test items of every rank, merged by rank 0."""
    from nbss_tpu_torch.data.synthetic import SyntheticDataModule
    from nbss_tpu_torch.eval.runner import run_test
    from nbss_tpu_torch.parallel import current_mesh

    mesh = current_mesh()
    dm = SyntheticDataModule(num_items=16, num_channels=2, audio_time_len=1.0,
                             batch_size=(4, 4), seeds=(3, 2, 5, 5), num_workers=0)
    train_items = [[p["index"] for p in b[2]] for b in dm.train_dataloader(0)]
    trainer = make_trainer(mesh=mesh)
    res = run_test(trainer, trainer.module, dm.test_dataloader(), os.path.join(out_dir, "test"),
                   metrics=["SI_SDR"], write_examples=0)
    return {"rank": mesh.rank, "host": mesh.host, "local_rank": mesh.local_rank,
            "train_items": train_items, "num_items": res["num_items"]}
