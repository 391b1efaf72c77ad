"""Room-impulse-response corpus generation on the device.

Counterpart of ``nbss_tpu/sim/generate.py``, with the same flags, files and
resumption: per room it simulates the reverberant RIR, the direct-path RIR
(and the noise RIR) and writes ``<index>.npz`` with the keys the datasets
read ({fs, RT60, room_sz, pos_src, pos_rcv, pos_noise, rir, rir_dp,
rir_noise, arr_geometry, selected_channels, beta}) into train/validation/test
subdirectories. Moving sources store per-source fp16 ``.npy`` RIR stacks.
Rooms are deterministic in (seed, index), so a rerun skips the rooms already
written. The simulation runs on the card unless ``--device cpu`` is given.

Run: python -m nbss_tpu_torch.sim.generate --rir_dir=... --spk_num=2 --rir_nums 4 1 1
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Optional, Tuple

import numpy as np

from nbss_tpu_torch.sim.config import RirConfigSampler
from nbss_tpu_torch.sim.ism import simulate_direct_path, simulate_rir
from nbss_tpu_torch.utils.device import resolve


def render_room(par: dict, fs: int, rir_dir: str, setdir: str,
                split_trajectory: Optional[int] = None,
                length_round: int = 1, device="cuda") -> str:
    index, RT60 = par["index"], par["RT60"]
    room_sz, beta = par["room_sz"], par.get("beta")
    pos_src, pos_rcv, pos_noise = par["pos_src"], par["pos_rcv"], par["pos_noise"]
    out_dir = os.path.join(rir_dir, setdir)
    os.makedirs(out_dir, exist_ok=True)
    save_to = os.path.join(out_dir, f"{index}.npz")

    if isinstance(pos_src, np.ndarray) and pos_src.ndim == 2:  # static sources
        rir = simulate_rir(room_sz, pos_src, pos_rcv, RT60, fs, beta=beta,
                           length_round=length_round, device=device)
        rir_dp = simulate_direct_path(room_sz, pos_src, pos_rcv, fs, device=device)
    else:  # trajectories: list of [N_i, 3] point sets
        rir, rir_dp = [], []
        for i, traj in enumerate(pos_src):
            chunks = ([traj] if not split_trajectory else
                      np.array_split(traj, max(1, -(-len(traj) // split_trajectory))))
            r = np.concatenate([simulate_rir(room_sz, c, pos_rcv, RT60, fs, beta=beta,
                                             length_round=length_round, device=device)
                                for c in chunks], axis=0)
            rdp = np.concatenate([simulate_direct_path(room_sz, c, pos_rcv, fs, device=device)
                                  for c in chunks], axis=0)
            np.save(os.path.join(out_dir, f"{index}_rir_{i}.npy"), r.astype(np.float16))
            np.savez_compressed(os.path.join(out_dir, f"{index}_rir_dp_{i}.npz"),
                                arr=rdp.astype(np.float16))
            rir.append(f"{index}_rir_{i}.npy")
            rir_dp.append(f"{index}_rir_dp_{i}.npz")
        pos_src = np.array([np.asarray(t, np.float16) for t in pos_src], dtype=object)

    rir_noise = None
    if len(pos_noise):
        rir_noise = simulate_rir(room_sz, pos_noise, pos_rcv, RT60, fs, beta=beta,
                                 length_round=length_round, device=device).astype(np.float16)
    np.savez(
        save_to, fs=fs, RT60=RT60, room_sz=room_sz, pos_src=pos_src,
        pos_rcv=pos_rcv, pos_noise=pos_noise, rir=rir, rir_dp=rir_dp,
        rir_noise=rir_noise, arr_geometry=par["arr_geometry"],
        selected_channels=par["selected_channels"], beta=beta,
    )
    return save_to


_ROOM_FILE_RE = re.compile(r"^(\d+)(\.npz|_rir_\d+\.npy|_rir_dp_\d+\.npz)$")


def migrate_splits(rir_dir: str, rir_nums: Tuple[int, int, int]) -> int:
    """Room indices are global across splits, so a rerun with another
    ``rir_nums`` moves the rooms a previous run rendered into the split their
    index now falls in (a room left behind would sit in two splits); rooms
    beyond the new total go to ``_excess/``. Returns the number of files moved."""
    n_train, n_val, n_test = rir_nums
    total = n_train + n_val + n_test
    moved = 0
    for setdir in ("train", "validation", "test"):
        d = os.path.join(rir_dir, setdir)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            m = _ROOM_FILE_RE.match(fname)
            if not m:
                continue
            index = int(m.group(1))
            want = ("train" if index < n_train
                    else "validation" if index < n_train + n_val
                    else "test" if index < total else "_excess")
            if want != setdir:
                dst = os.path.join(rir_dir, want)
                os.makedirs(dst, exist_ok=True)
                os.replace(os.path.join(d, fname), os.path.join(dst, fname))
                moved += 1
    return moved


def generate_rir_files(sampler: RirConfigSampler, rir_dir: str,
                       rir_nums: Tuple[int, int, int],
                       split_trajectory: Optional[int] = None,
                       length_round: int = 1, device="cuda") -> None:
    resolve(device)  # before any file moves
    rir_dir = os.path.expanduser(rir_dir)
    n_train, n_val, n_test = rir_nums
    total = n_train + n_val + n_test
    moved = migrate_splits(rir_dir, rir_nums)
    if moved:
        print(f"migrated {moved} room files to their splits for "
              f"rir_nums={rir_nums}", flush=True)
    for index in range(total):
        setdir = ("train" if index < n_train
                  else "validation" if index < n_train + n_val else "test")
        if os.path.exists(os.path.join(rir_dir, setdir, f"{index}.npz")):
            continue  # resumable: rooms are deterministic in (seed, index)
        par = sampler.sample(index)
        render_room(par, sampler.fs, rir_dir, setdir, split_trajectory,
                    length_round=length_round, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="RIR corpus generation on the device")
    p.add_argument("--rir_dir", required=True)
    p.add_argument("--spk_num", type=int, default=2)
    p.add_argument("--noise_num", type=int, default=1)
    p.add_argument("--rir_nums", type=int, nargs=3, default=(40000, 5000, 3000))
    p.add_argument("--arr_geometry", default="circular+cm")
    p.add_argument("--mic_num", type=int, default=6)
    p.add_argument("--fs", type=int, default=8000)
    p.add_argument("--RT60_lim", type=float, nargs=2, default=(0.1, 0.6))
    p.add_argument("--trajectory", default=None,
                   help="e.g. '4points+sin,0.05' for moving sources")
    p.add_argument("--split_trajectory", type=int, default=None)
    p.add_argument("--length_round", type=int, default=2048,
                   help="round RIR length up to a multiple")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    traj = None
    if args.trajectory:
        kind, spacing = args.trajectory.split(",")
        traj = (kind, float(spacing))
    sampler = RirConfigSampler(
        spk_num=args.spk_num, noise_num=args.noise_num,
        arr_geometry=args.arr_geometry, mic_num=args.mic_num, fs=args.fs,
        RT60_lim=tuple(args.RT60_lim), trajectory=traj, seed=args.seed)
    generate_rir_files(sampler, args.rir_dir, tuple(args.rir_nums),
                       args.split_trajectory, length_round=args.length_round,
                       device=args.device)


if __name__ == "__main__":
    main()
