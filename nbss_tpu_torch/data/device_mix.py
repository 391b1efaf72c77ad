"""Mixtures made on the device from a room corpus and per-item keys.

Counterpart of ``nbss_tpu/data/device_mix.py``. The host supplies only RIR
stacks (or, with the corpus preloaded onto the device, room and source
indices); spatialization (FFT convolution with direct-path alignment),
overlap placement, SIR scaling, spatially diffuse noise at a target SNR and
peak normalization run on the device for the whole batch, every draw taken
from ``fold_in(key, seed)`` of the item's seed with the port's copy of
``jax.random`` (``utils/prng.py``). The same key, seeds and rooms therefore
give the JAX package's mixtures, draw for draw.

On several ranks a rank mixes only its rows of each host batch: every draw
comes from the item's own key, so its rows are the JAX package's rows of the
global batch.

As in the JAX package, the dry source is masked to its segment before the
convolution, so the reverberant tail runs past the segment's end, and the
host's random numbers only pick the room file and the sources in it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.parallel.mesh import Shard
from nbss_tpu_torch.utils import prng
from nbss_tpu_torch.utils.device import resolve

OVLP_SET = {
    "full": ("full",),
    "mid": ("mid",),
    "start": ("start",),
    "end": ("end",),
    "startend": ("start", "end"),
    "headtail": ("headtail",),
    "hms": ("headtail", "mid", "start", "end"),
    "fhms": ("full", "headtail", "mid", "start", "end"),
}
_TYPE_ID = {"full": 0, "mid": 1, "start": 2, "end": 3, "headtail": 4}


def fft_convolve(x: torch.Tensor, h: torch.Tensor, nfft: int) -> torch.Tensor:
    """Linear convolution along the last axis via one shared rfft size.

    x [..., T], h [..., L] -> [..., nfft] (valid up to T+L-1; nfft >= T+L-1).
    """
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    H = torch.fft.rfft(h, n=nfft, dim=-1)
    return torch.fft.irfft(X * H, n=nfft, dim=-1)


def trajectory_windows(T: int, P: int, wintype: str = "trapezium20") -> np.ndarray:
    """Full-length crossfade windows W [P, T] for a P-point trajectory over a
    T-sample clip: window i is the 2*hop crossfade window centered at i*hop,
    with hop chosen so the P windows tile [0, T] and adjacent ramps sum to 1
    (hop even, so the trapezium's zero pads split symmetrically)."""
    from nbss_tpu_torch.data.mixing import _crossfade_window

    assert P >= 2, P
    hop = -(-T // (P - 1))
    hop += hop % 2
    win = _crossfade_window(hop, wintype)  # [2*hop]
    W = np.zeros((P, T), np.float32)
    for i in range(P):
        lo = i * hop - hop
        src_lo, src_hi = max(0, -lo), min(2 * hop, T - lo)
        if src_hi > src_lo:
            W[i, lo + src_lo:lo + src_hi] = win[src_lo:src_hi]
    return W


def trajectory_convolve(dry: torch.Tensor, rir: torch.Tensor, W: torch.Tensor,
                        nfft: int) -> torch.Tensor:
    """Moving-source spatialization: sum_p conv(dry * W[p], rir[..., p]).

    dry [..., S, T], rir [..., S, P, C, L], W [P, T] -> [..., S, C, nfft]."""
    dry_w = dry[..., :, None, :] * W                    # [..., S, P, T]
    wet_p = fft_convolve(dry_w[..., None, :], rir, nfft)  # [..., S, P, C, nfft]
    return wet_p.sum(dim=-3)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def synth_speech(key: torch.Tensor, T: int, fs: int) -> torch.Tensor:
    """Speech-like source: formant-shaped noise with a syllabic envelope and
    pauses; keys [..., 2] -> [..., T]. The shaping is one rfft round trip: a
    1/f tilt plus 3 random formant-like resonances."""
    dev = key.device
    k_exc, k_formant, k_tilt, k_env, k_gate, k_f0 = prng.split(key, 6).unbind(-2)
    x = prng.normal(k_exc, (T,))

    F = T // 2 + 1
    f = torch.arange(F, dtype=torch.float32, device=dev) * (fs / T)  # Hz per bin
    # spectral tilt: one-pole-like low pass with a random knee of 300-800 Hz
    knee = 300.0 + 500.0 * prng.uniform(k_tilt)
    shape = 1.0 / torch.sqrt(1.0 + (f / knee[..., None]) ** 2)
    # 3 random formants: gaussian bumps, 250-3200 Hz
    lo, hi = torch.log(_f32(250.0, dev)), torch.log(_f32(min(3200.0, 0.45 * fs), dev))
    cf = torch.exp(prng.uniform(k_formant, (3,), lo, hi))
    bw = 80.0 + 120.0 * prng.uniform(k_f0, (3,))
    bumps = torch.exp(-0.5 * ((f[:, None] - cf[..., None, :]) / bw[..., None, :]) ** 2)
    shape = shape * (1.0 + 4.0 * bumps.sum(-1))
    y = torch.fft.irfft(torch.fft.rfft(x) * shape, n=T)

    # syllabic-rate AM (3-5 Hz) + on/off gating at 0.5 s resolution
    t = torch.arange(T, dtype=torch.float32, device=dev) / fs
    rate = 3.0 + 2.0 * prng.uniform(k_env)
    phase = prng.uniform(k_env, (), 0.0, 6.28)
    env = (0.5 * (1.0 + torch.sin(2.0 * np.pi * rate[..., None] * t + phase[..., None]))) ** 1.5
    blk = fs // 2
    nblk = -(-T // blk)
    gate = (prng.uniform(k_gate, (nblk,)) > 0.2).to(torch.float32)
    gate[..., 0] = 1.0  # never fully silent
    gate = torch.repeat_interleave(gate, blk, dim=-1)[..., :T]
    return y * env * gate


def _sample_overlap(key: torch.Tensor, types: Tuple[str, ...],
                    ratio_range: Tuple[float, float], T: int):
    """Overlap placement of two speakers in a T-sample clip: keys [..., 2] ->
    (lens [..., 2], shifts [..., 2]) int64."""
    k_type, k_ratio, k_which, k_shift = prng.split(key, 4).unbind(-2)
    type_ids = torch.tensor([_TYPE_ID[t] for t in types], dtype=torch.int64, device=key.device)
    tid = type_ids[prng.randint(k_type, (), 0, len(types))]
    ratio = prng.uniform(k_ratio, (), ratio_range[0], ratio_range[1])
    short = torch.clamp((T * ratio).to(torch.int64), min=1)  # truncation, as astype(int32)
    ht_len = (T * (0.5 + ratio / 2.0)).to(torch.int64)
    which = prng.randint(k_which, (), 0, 2)
    shift_mid = prng.randint(k_shift, (), 0, torch.clamp(T - short + 1, min=1))

    def pick(*v):
        v = torch.stack(torch.broadcast_tensors(*(torch.as_tensor(a, device=key.device)
                                                  for a in v)), dim=-1)
        return torch.gather(v, -1, tid[..., None])[..., 0]

    len_short = pick(T, short, short, short, ht_len)
    len_long = pick(T, T, T, T, ht_len)
    sh_short = pick(0, shift_mid, 0, T - len_short, T - ht_len)
    sh_long = torch.zeros_like(sh_short)
    first = (which == 0)[..., None]
    lens = torch.where(first, torch.stack([len_short, len_long], -1),
                       torch.stack([len_long, len_short], -1))
    shifts = torch.where(first, torch.stack([sh_short, sh_long], -1),
                         torch.stack([sh_long, sh_short], -1))
    # headtail: speaker 0 at the head, speaker 1 at the tail
    ht = (tid == 4)[..., None]
    shifts = torch.where(ht, torch.stack([torch.zeros_like(ht_len), T - ht_len], -1), shifts)
    lens = torch.where(ht, torch.stack([ht_len, ht_len], -1), lens)
    return lens, shifts


def _babble(n: torch.Tensor, fs: int) -> torch.Tensor:
    """Speech-tilted spectrum of white excitation [..., T]."""
    T = n.shape[-1]
    N_ = torch.fft.rfft(n, dim=-1)
    f = torch.arange(N_.shape[-1], dtype=torch.float32, device=n.device)
    shape = 1.0 / torch.sqrt(1.0 + (f * (fs / T) / 500.0) ** 2)
    return torch.fft.irfft(N_ * shape, n=T, dim=-1)


def _spatialize(n: torch.Tensor, cs_re: torch.Tensor, cs_im: torch.Tensor,
                stft: STFT) -> torch.Tensor:
    """Independent channel noise [..., C, T] mixed per frequency by conj(Cs)
    in the STFT domain."""
    X, T = stft.stft(n)  # [..., C, F, T']
    Cs = torch.complex(cs_re, cs_im)  # [F, M, M]
    Y = torch.einsum("fmn,...mft->...nft", Cs.conj(), X)
    return stft.istft(Y, T)


def _diffuse_noise(key: torch.Tensor, C: int, T: int, cs_re: torch.Tensor,
                   cs_im: torch.Tensor, stft: STFT, babble_fs: Optional[int] = None):
    """Spatially diffuse noise [..., C, T] from keys [..., 2]; ``babble_fs``
    (the sample rate) gives the excitation a speech-like spectrum."""
    n = prng.normal(key, (C, T))
    if babble_fs is not None:
        n = _babble(n, babble_fs)
    return _spatialize(n, cs_re, cs_im, stft)


def mix_draws(key: torch.Tensor, seeds: torch.Tensor, ovlp: str,
              ratio_range: Tuple[float, float], T: int, n_noise_types: int) -> Dict:
    """The discrete draws of ``mix_batch`` for a stage key [2] and seeds [B]:
    the item keys and their six subkeys, each speaker's segment (lens,
    shifts [B, 2]) and the noise type [B]."""
    keys = prng.fold_in(key, seeds.to(key.device))          # [B, 2]
    ks = prng.split(keys, 6)                                 # [B, 6, 2]
    lens, shifts = _sample_overlap(ks[:, 0], OVLP_SET[ovlp], tuple(ratio_range), T)
    nt = prng.randint(ks[:, 3], (), 0, n_noise_types)
    return {"keys": keys, "ks": ks, "lens": lens, "shifts": shifts, "noise_type": nt}


def _take(sig: torch.Tensor, start: torch.Tensor, T: int) -> torch.Tensor:
    """sig[..., s:s+T] for per-(item, source) starts [B, S]; the start is
    clamped into [0, len - T] as ``jax.lax.dynamic_slice_in_dim`` clamps it."""
    start = torch.clamp(start, 0, sig.shape[-1] - T)
    idx = start[..., None, None] + torch.arange(T, device=sig.device)  # [B, S, 1, T]
    return torch.gather(sig, -1, idx.expand(*sig.shape[:-1], T))


@torch.no_grad()
def mix_batch(key: torch.Tensor, seeds: torch.Tensor, rir: torch.Tensor, rir_dp: torch.Tensor,
              cs_re: torch.Tensor, cs_im: torch.Tensor, dry: Optional[torch.Tensor] = None,
              traj_win: Optional[torch.Tensor] = None, *, T: int, fs: int, rir_len: int,
              dp_len: int, ovlp: str = "mid", ratio_range: Tuple[float, float] = (0.1, 1.0),
              sir_range: Optional[Tuple[float, float]] = (-5.0, 5.0),
              snr_range: Tuple[float, float] = (0.0, 20.0),
              noise_types: Tuple[str, ...] = ("babble", "white"),
              nfft: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [B, C, T], ys [B, S, C, T]) on the device of ``rir``.

    key [2] (the stage key), seeds [B] (the items' seeds); rir [B, S, C,
    rir_len] and rir_dp [B, S, C, dp_len], or with ``traj_win`` [P, T] moving
    sources [B, S, P, C, rir_len] / [B, S, P, C, dp_len]; cs_re/cs_im [F, C,
    C] the diffuse-noise mixing matrices; dry [B, S, T] or None to synthesize
    speech-like sources."""
    dev = rir.device
    key = key.to(dev)
    B, S, C = rir.shape[0], rir.shape[1], rir.shape[-2]
    if nfft == 0:
        nfft = 1 << (T + rir_len - 1).bit_length()
    noise_stft = STFT(n_fft=2 * (cs_re.shape[0] - 1), n_hop=(cs_re.shape[0] - 1) // 2)
    d = mix_draws(key, seeds, ovlp, ratio_range, T, len(noise_types))
    ks, lens, shifts = d["ks"], d["lens"], d["shifts"]

    if dry is None:
        dry = torch.stack([synth_speech(prng.fold_in(ks[:, 1], s), T, fs) for s in range(S)], 1)
    idx = torch.arange(T, device=dev)
    seg = (idx >= shifts[..., None]) & (idx < (shifts + lens)[..., None])  # [B, S, T]
    dry = dry * seg.to(torch.float32)

    if traj_win is not None:  # moving sources: [B, S, P, C, L] RIR stacks
        wet_full = trajectory_convolve(dry, rir, traj_win, nfft)
        tgt_full = trajectory_convolve(dry, rir_dp, traj_win, nfft)
        # align by the FIRST trajectory point's ref-channel peak
        delay = torch.argmax(rir[:, :, 0, 0, :], dim=-1)  # [B, S]
    else:
        wet_full = fft_convolve(dry[:, :, None, :], rir, nfft)  # [B, S, C, nfft]
        tgt_full = fft_convolve(dry[:, :, None, :], rir_dp, nfft)
        # align by the reverberant RIR's ref-channel peak
        delay = torch.argmax(rir[:, :, 0, :], dim=-1)  # [B, S]
    wet = _take(wet_full, delay, T)  # [B, S, C, T]
    tgt = _take(tgt_full, delay, T)
    del wet_full, tgt_full

    if sir_range is not None and S == 2:
        sir = prng.uniform(ks[:, 2], (), sir_range[0], sir_range[1])
        e0 = (wet[:, 0] ** 2).mean((-2, -1)) + 1e-12
        e1 = (wet[:, 1] ** 2).mean((-2, -1)) + 1e-12
        coeff = torch.sqrt(e0 / e1 * 10.0 ** (-sir / 10.0))
        gain = torch.stack([torch.ones_like(coeff), coeff], -1)[..., None, None]
        wet, tgt = wet * gain, tgt * gain

    mix = wet.sum(dim=1)  # [B, C, T]
    n = prng.normal(ks[:, 4], (C, T))
    babble = torch.tensor([name != "white" for name in noise_types], device=dev)
    if bool(babble.any()):
        n = torch.where(babble[d["noise_type"]][:, None, None], _babble(n, fs), n)
    noise = _spatialize(n, cs_re.to(dev), cs_im.to(dev), noise_stft)

    snr = prng.uniform(ks[:, 5], (), snr_range[0], snr_range[1])
    em = (mix ** 2).mean((-2, -1)) + 1e-12
    en = (noise ** 2).mean((-2, -1)) + 1e-12
    noise = noise * torch.sqrt(em / en * 10.0 ** (-snr / 10.0))[:, None, None]
    mix = mix + noise

    peak = torch.maximum(mix.abs().amax((-2, -1)),
                         torch.clamp(tgt.abs().amax((-3, -2, -1)), min=1e-9))
    scale = 0.9 / peak
    return mix * scale[:, None, None], tgt * scale[:, None, None, None]


class DeviceMixLoader:
    """Wraps a host batch loader of (rir, rir_dp, paras) or, with the corpus
    on the device, (room, spk, paras); yields mixed (x, ys, paras) batches.
    The items' seeds ride in paras."""

    def __init__(self, base_loader, mix_fn, base_key: torch.Tensor,
                 as_numpy: bool = False, paras_extra: Optional[Dict] = None):
        self.base = base_loader
        self.mix_fn = mix_fn
        self.key = base_key
        self.as_numpy = as_numpy  # test/predict consumers want host arrays
        self.paras_extra = paras_extra or {}

    def __len__(self):
        return len(self.base)

    def __iter__(self):
        for batch in self.base:  # on several ranks: this rank's rows (a Shard)
            rir, rir_dp, paras = batch
            seeds = torch.tensor([p["seed"] % (2 ** 31) for p in paras], dtype=torch.int64)
            x, ys = self.mix_fn(self.key, seeds, torch.from_numpy(np.asarray(rir)),
                                torch.from_numpy(np.asarray(rir_dp)))
            if self.as_numpy:
                x, ys = x.cpu().numpy(), ys.cpu().numpy()
            for p in paras:
                p.update(self.paras_extra)
            yield Shard.like(batch, (x, ys, paras))


class DeviceRirDataset:
    """Host side of the pipeline: per (index, seed) pick a room npz and a
    subset of its sources (file IO and selection only) and return
    fixed-shape RIR stacks; the waveform math happens on the device."""

    def __init__(self, rir_dir: str, subdir: str, num_spk: int, rir_len: int,
                 dp_len: int, num_items: int, shuffle_rir: bool,
                 traj_points: int = 0):
        self.rir_dir = Path(rir_dir).expanduser() / subdir
        self.rirs = sorted(str(r) for r in self.rir_dir.rglob("*.npz")
                           if not r.name.startswith("diffuse")
                           and "_rir_" not in r.name)
        if not self.rirs:
            raise FileNotFoundError(f"{self.rir_dir} is empty or missing")
        self.num_spk = num_spk
        self.rir_len = rir_len
        self.dp_len = dp_len
        self.num_items = num_items
        self.shuffle_rir = shuffle_rir
        self.traj_points = traj_points
        self.index_mode = False  # see set_index_mode / preload
        self.room_meta = None

    def __len__(self):
        return self.num_items

    @staticmethod
    def _fit(a: np.ndarray, L: int) -> np.ndarray:
        if a.shape[-1] >= L:
            return a[..., :L]
        pad = [(0, 0)] * (a.ndim - 1) + [(0, L - a.shape[-1])]
        return np.pad(a, pad)

    def _room_n_src(self, path) -> int:
        """Source count of one room npz without decompressing its RIRs:
        trajectory rooms store a file name list under 'rir'; static rooms
        get a header-only read of the stacked array's shape."""
        if self.traj_points:
            return len(np.load(path, allow_pickle=True)["rir"])
        import zipfile

        from numpy.lib import format as npf

        with zipfile.ZipFile(path) as zf:
            with zf.open("rir.npy") as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    shape, _, _ = npf.read_array_header_1_0(f)
                else:
                    shape, _, _ = npf.read_array_header_2_0(f)
        return shape[0]

    def set_index_mode(self, room_meta) -> None:
        """Yield (room_idx, spk_idx, paras) int items instead of RIR arrays,
        for stacks preloaded onto the device. The host random draws are the
        array mode's, call for call, so the mixtures are the same either way."""
        assert len(room_meta) == len(self.rirs), (len(room_meta), len(self.rirs))
        self.index_mode = True
        self.room_meta = room_meta

    def _trajectory(self, root: Path, name: str, dp_name: str):
        """One moving source's RIR stacks, subsampled to traj_points points."""
        r = np.load(root / str(name))  # [N, C, L] (fp16)
        rdp = np.load(root / str(dp_name), allow_pickle=True)["arr"]
        sel = np.round(np.linspace(0, r.shape[0] - 1, self.traj_points)).astype(int)
        dsel = np.round(np.linspace(0, rdp.shape[0] - 1, self.traj_points)).astype(int)
        return r[sel], rdp[dsel]

    def preload(self, budget_bytes: int):
        """Every room once, in rectangular stacks for the device:
        {'rir': [R, S, (P,) C, rir_len], 'rir_dp': ..., 'meta': [...]} in the
        rooms' stored dtype (fp16 trajectory stacks stay fp16; the gather
        casts to fp32, as the array path's load does), or None when the
        corpus exceeds ``budget_bytes`` or the rooms hold different source
        counts (the callers then read per item). A header-only pass rejects
        ragged corpora before any RIR is decompressed."""
        if len({self._room_n_src(p) for p in self.rirs}) > 1:
            return None
        rirs, dps, metas = [], [], []
        for path in self.rirs:
            z = np.load(path, allow_pickle=True)
            if self.traj_points:
                root = Path(path).parent
                pairs = [self._trajectory(root, n, d)
                         for n, d in zip(list(z["rir"]), list(z["rir_dp"]))]
                rir = np.stack([self._fit(r, self.rir_len) for r, _ in pairs])
                rir_dp = np.stack([self._fit(d, self.dp_len) for _, d in pairs])
            else:
                rir = self._fit(np.asarray(z["rir"]), self.rir_len)
                rir_dp = self._fit(np.asarray(z["rir_dp"]), self.dp_len)
            if rirs and rir.shape != rirs[0].shape:
                return None
            if not rirs and ((rir.nbytes + rir_dp.nbytes) * len(self.rirs)
                             > budget_bytes):
                return None
            rirs.append(rir)
            dps.append(rir_dp)
            metas.append({"n_src": rir.shape[0], "RT60": float(z["RT60"])})
        return {"rir": np.stack(rirs), "rir_dp": np.stack(dps), "meta": metas}

    def __getitem__(self, item):
        index, seed = item if isinstance(item, tuple) else (item, item)
        rng = np.random.default_rng(np.random.PCG64(seed))
        ri = (int(rng.integers(0, len(self.rirs)))
              if self.shuffle_rir else index % len(self.rirs))
        path = self.rirs[ri]
        if self.index_mode:
            n_src = self.room_meta[ri]["n_src"]
            spk_idx = rng.choice(n_src, size=self.num_spk,
                                 replace=False).astype(np.int32)
            paras = {"index": index, "seed": int(seed), "rir_file": path,
                     "RT60": self.room_meta[ri]["RT60"],
                     "saveto": [f"{index}_{s}.wav" for s in range(self.num_spk)]}
            return np.int32(ri), spk_idx, paras
        z = np.load(path, allow_pickle=True)
        if self.traj_points:  # trajectory rooms: per-source .npy RIR stacks
            names, dp_names = list(z["rir"]), list(z["rir_dp"])
            spk_idx = rng.choice(len(names), size=self.num_spk, replace=False)
            root = Path(path).parent
            pairs = [self._trajectory(root, names[i], dp_names[i]) for i in spk_idx]
            rir = self._fit(np.stack([r for r, _ in pairs]).astype(np.float32), self.rir_len)
            rir_dp = self._fit(np.stack([d for _, d in pairs]).astype(np.float32), self.dp_len)
        else:
            rir = np.asarray(z["rir"], np.float32)
            rir_dp = np.asarray(z["rir_dp"], np.float32)
            spk_idx = rng.choice(rir.shape[0], size=self.num_spk, replace=False)
            rir = self._fit(rir[spk_idx], self.rir_len)
            rir_dp = self._fit(rir_dp[spk_idx], self.dp_len)
        paras = {"index": index, "seed": int(seed), "rir_file": path,
                 "RT60": float(z["RT60"]),
                 "saveto": [f"{index}_{s}.wav" for s in range(self.num_spk)]}
        return rir, rir_dp, paras


@dataclass
class DeviceSyntheticDataModule(DataModule):
    """A simulated-room RIR corpus (``python -m nbss_tpu_torch.sim.generate``)
    and speech-like sources synthesized on the device, mixed on ``device``
    (the card unless the caller asks for the CPU). Stage seeds default to
    (None, 2, 3, 3)."""

    rir_dir: str = "~/rir_corpus"
    num_spk: int = 2
    sample_rate: int = 8000
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, 4.0, 4.0)
    num_items: Tuple[int, ...] = (2000, 256, 256, 256)
    rir_len: int = 6144
    dp_len: int = 1024
    ovlp: str = "mid"
    speech_overlap_ratio: Tuple[float, float] = (0.1, 1.0)
    sir: Optional[Tuple[float, float]] = (-5.0, 5.0)
    snr: Tuple[float, float] = (0.0, 20.0)
    noise_type: Tuple[str, ...] = ("babble", "white")
    mix_key: int = 0
    trajectory_points: int = 0  # >0: moving sources (P-point RIR stacks)
    # None = auto: preload the whole RIR corpus onto the device when it fits
    # NBSS_RIR_PRELOAD_MB (default 1024 MB); True forces it, False disables.
    preload_rir: Optional[bool] = None
    device: str = "cuda"
    # the items are room and source picks (indices when preloaded) and the
    # mixing runs on the device in the consumer, so the picks stay in the
    # calling thread unless asked for; any count gives the same batches
    num_workers: int = 0

    _cs_cache: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, init=False, repr=False, compare=False)
    _preload_cache: Dict = field(default_factory=dict, init=False, repr=False,
                                 compare=False)

    def __post_init__(self):
        self.device = str(resolve(self.device))

    def _subdir(self, stage_idx: int) -> str:
        return ("train", "validation", "test", "test")[stage_idx]

    def _make_dataset(self, stage_idx: int):
        ds = DeviceRirDataset(
            self.rir_dir, self._subdir(stage_idx), self.num_spk, self.rir_len,
            self.dp_len, self.num_items[stage_idx], shuffle_rir=stage_idx == 0,
            traj_points=self.trajectory_points)
        pre = self._preload_cache.get(self._subdir(stage_idx))
        if pre is not None:
            ds.set_index_mode(pre["meta"])
        return ds

    def _preloaded(self, stage_idx: int):
        """The stage's RIR stacks on the device, uploaded once per process:
        the hot loop then uploads only the items' room and source indices."""
        sub = self._subdir(stage_idx)
        if sub in self._preload_cache:
            return self._preload_cache[sub]
        enabled = self.preload_rir
        if enabled is None:
            enabled = os.environ.get("NBSS_RIR_PRELOAD", "1") != "0"
        pre = None
        if enabled:
            ds = DeviceRirDataset(
                self.rir_dir, sub, self.num_spk, self.rir_len, self.dp_len,
                1, shuffle_rir=False, traj_points=self.trajectory_points)
            budget = (1 << 62 if self.preload_rir else
                      int(os.environ.get("NBSS_RIR_PRELOAD_MB", "1024")) << 20)
            raw = ds.preload(budget)
            if raw is not None:
                pre = {"rir": torch.from_numpy(raw["rir"]).to(self.device),
                       "rir_dp": torch.from_numpy(raw["rir_dp"]).to(self.device),
                       "meta": raw["meta"]}
        self._preload_cache[sub] = pre
        return pre

    def _cs(self) -> Tuple[np.ndarray, np.ndarray]:
        """The diffuse-noise mixing matrices of the first train room's array
        (cached as diffuse.npz in the corpus)."""
        if self._cs_cache is None:
            from nbss_tpu_torch.data.diffuse import spatial_coherence_mixing_matrices

            root = Path(self.rir_dir).expanduser()
            cache = root / "diffuse.npz"
            if cache.exists():
                Cs = np.load(cache, allow_pickle=True)["Cs"]
            else:
                first = sorted((root / "train").rglob("*.npz"))[0]
                pos = np.load(first, allow_pickle=True)["pos_rcv"]
                _, Cs = spatial_coherence_mixing_matrices(
                    pos_mics=np.asarray(pos, np.float64), fs=self.sample_rate,
                    noise_field="spherical", nfft=256)
                try:
                    np.savez(cache, Cs=Cs)
                except OSError:
                    pass
            self._cs_cache = (np.ascontiguousarray(Cs.real, dtype=np.float32),
                              np.ascontiguousarray(Cs.imag, dtype=np.float32))
        return self._cs_cache

    def stage_key(self, stage_idx: int) -> torch.Tensor:
        """fold_in(PRNGKey(mix_key), stage): train, val and test never share draws."""
        return prng.fold_in(prng.PRNGKey(self.mix_key), stage_idx).to(self.device)

    def _loader(self, stage_idx: int, epoch: int = 0, shuffle=None):
        pre = self._preloaded(stage_idx)  # before _make_dataset (index mode)
        base = super()._loader(stage_idx, epoch, shuffle)
        dev = torch.device(self.device)
        cs_re, cs_im = (torch.from_numpy(a).to(dev) for a in self._cs())
        T = int(self.audio_time_len[stage_idx] * self.sample_rate)
        W = (torch.from_numpy(trajectory_windows(T, self.trajectory_points)).to(dev)
             if self.trajectory_points else None)
        kw = dict(T=T, fs=self.sample_rate, rir_len=self.rir_len, dp_len=self.dp_len,
                  ovlp=self.ovlp, ratio_range=tuple(self.speech_overlap_ratio),
                  sir_range=tuple(self.sir) if self.sir is not None else None,
                  snr_range=tuple(self.snr), noise_types=tuple(self.noise_type))

        if pre is not None:
            stack_r, stack_dp = pre["rir"], pre["rir_dp"]

            def mix_fn(key, seeds, room, spk):
                # gather from the resident stacks; the fp32 cast is the array
                # path's load-time cast
                room, spk = room.to(dev, torch.int64), spk.to(dev, torch.int64)
                r = stack_r[room[:, None], spk].float()
                rdp = stack_dp[room[:, None], spk].float()
                return mix_batch(key, seeds, r, rdp, cs_re, cs_im, traj_win=W, **kw)
        else:
            def mix_fn(key, seeds, rir, rir_dp):
                return mix_batch(key, seeds, rir.to(dev), rir_dp.to(dev), cs_re, cs_im,
                                 traj_win=W, **kw)

        return DeviceMixLoader(
            base, mix_fn, self.stage_key(stage_idx), as_numpy=stage_idx >= 2,
            paras_extra={"sample_rate": self.sample_rate,
                         "dataset": f"DeviceSynth/{self._subdir(stage_idx)}"})
