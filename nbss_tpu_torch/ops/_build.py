"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface and includes only CUDA
headers (and the ``csrc/*.cuh`` headers beside it), so the whole set compiles into one shared library in seconds, with
no PyTorch headers and no ``ninja``: one ``nvcc -c`` per source, all started
together, then one link. The library goes to ``build/kernels/`` at the
repository root, named by a hash of the sources, headers and flags, so a stale
build is never loaded. The build happens at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 300

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "-shared")).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbss_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; "
                           "the CUDA kernels cannot be built")
    return nvcc


def build() -> float:
    """Compile the kernels unless this exact build exists. Returns the seconds
    the compile took (0.0 when the library was already built). Processes that
    start together (the ranks of a data-parallel run) take a file lock, so
    one builds and the others load its library."""
    import fcntl

    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return 0.0 if out.exists() else _compile(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile(out: Path) -> float:
    nvcc, srcs, pid = _nvcc(), sources(), os.getpid()
    objs = [BUILD_DIR / f"{out.stem}.{src.stem}.{pid}.o" for src in srcs]
    tmp = out.with_suffix(f".{pid}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    try:
        logs = [p.communicate(timeout=max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0)))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for src, p, (stdout, stderr) in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{stdout}\n{stderr}")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    print(f"[build] nvcc built {out.name} from {len(srcs)} source(s) in parallel in "
          f"{seconds:.1f} s\n" + "\n".join(err.strip() for _, err in logs), flush=True)
    return seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbss_attention_block_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                 ctypes.c_float, p]
        lib.nbss_attention_block_fwd.restype = i
        lib.nbss_attention_block_tc_fwd.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, p]
        lib.nbss_attention_block_tc_fwd.restype = i
        lib.nbss_attention_block_tc_workspace_bytes.argtypes = [i, i]
        lib.nbss_attention_block_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.nbss_attention_block_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                                 ctypes.c_float, p]
        lib.nbss_attention_block_bwd.restype = i
        lib.nbss_attention_block_bwd_tc.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
        lib.nbss_attention_block_bwd_tc.restype = i
        lib.nbss_attention_block_bwd_tc_workspace_bytes.argtypes = [i] * 5
        lib.nbss_attention_block_bwd_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.nbss_attention_block_bwd_workspace_floats.argtypes = [i]
        lib.nbss_attention_block_bwd_workspace_floats.restype = ctypes.c_longlong
        f = ctypes.c_float
        lib.nbss_attention_block_wide_tc_workspace_bytes.argtypes = [i] * 5
        lib.nbss_attention_block_wide_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.nbss_attention_block_wide_tc_fwd.argtypes = [p] * 7 + [i] * 6 + [f, p]
        lib.nbss_attention_block_wide_tc_fwd.restype = i
        lib.nbss_attention_block_wide_bwd_tc_workspace_bytes.argtypes = [i] * 6
        lib.nbss_attention_block_wide_bwd_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.nbss_attention_block_wide_bwd_tc.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.nbss_attention_block_wide_bwd_tc.restype = i
        lib.nbss_attention_block_wide_workspace_bytes.argtypes = [i] * 5
        lib.nbss_attention_block_wide_workspace_bytes.restype = ctypes.c_longlong
        lib.nbss_attention_block_wide_fwd.argtypes = [p] * 7 + [i] * 5 + [f, p]
        lib.nbss_attention_block_wide_fwd.restype = i
        lib.nbss_attention_block_wide_bwd.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.nbss_attention_block_wide_bwd.restype = i
        lib.nbss_selective_scan_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.nbss_selective_scan_fwd.restype = i
        lib.nbss_selective_scan_bwd.argtypes = [p] * 15 + [i] * 5 + [p]
        lib.nbss_selective_scan_bwd.restype = i
        lib.nbss_selective_scan_bwd_workspace_floats.argtypes = [i] * 4
        lib.nbss_selective_scan_bwd_workspace_floats.restype = ctypes.c_longlong
        lib.nbss_selective_scan_chunk.argtypes = []
        lib.nbss_selective_scan_chunk.restype = i
        lib.nbss_selective_scan_state_group.argtypes = []
        lib.nbss_selective_scan_state_group.restype = i
        ll, f = ctypes.c_longlong, ctypes.c_float
        lib.nbss_narrowband_attention_fwd.argtypes = [p] * 6 + [ll] * 3 + [i] * 6 + [f, p]
        lib.nbss_narrowband_attention_fwd.restype = i
        lib.nbss_narrowband_attention_tc_fwd.argtypes = [p] * 6 + [ll] * 3 + [i] * 6 + [f, p]
        lib.nbss_narrowband_attention_tc_fwd.restype = i
        lib.nbss_narrowband_attention_bwd.argtypes = [p] * 10 + [ll] * 3 + [i] * 6 + [f, p]
        lib.nbss_narrowband_attention_bwd.restype = i
        lib.nbss_narrowband_attention_bwd_tc.argtypes = [p] * 10 + [ll] * 3 + [i] * 6 + [f, p]
        lib.nbss_narrowband_attention_bwd_tc.restype = i
        lib.nbss_narrowband_attention_max_width.argtypes = []
        lib.nbss_narrowband_attention_max_width.restype = i
        lib.nbss_narrowband_attention_max_v_width.argtypes = []
        lib.nbss_narrowband_attention_max_v_width.restype = i
        lib.nbss_attention_block_relpos_fwd.argtypes = [p] * 15 + [i] * 5 + [f, p]
        lib.nbss_attention_block_relpos_fwd.restype = i
        lib.nbss_attention_block_relpos_tc_fwd.argtypes = [p] * 11 + [i] * 6 + [f, p]
        lib.nbss_attention_block_relpos_tc_fwd.restype = i
        lib.nbss_attention_block_relpos_tc_workspace_bytes.argtypes = [i] * 4
        lib.nbss_attention_block_relpos_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.nbss_attention_block_relpos_head_cols.argtypes = []
        lib.nbss_attention_block_relpos_head_cols.restype = i
        lib.nbss_attention_block_relpos_key_cols.argtypes = []
        lib.nbss_attention_block_relpos_key_cols.restype = i
        lib.nbss_tconvffn_fwd.argtypes = [p] * 5 + [i] * 5 + [f, p]
        lib.nbss_tconvffn_fwd.restype = i
        lib.nbss_tconvffn_tc_fwd.argtypes = [p] * 5 + [i] * 5 + [f, p]
        lib.nbss_tconvffn_tc_fwd.restype = i
        lib.nbss_tconvffn_tc_words.argtypes = [i, i]
        lib.nbss_tconvffn_tc_words.restype = i
        lib.nbss_tconvffn_tile_frames.argtypes = []
        lib.nbss_tconvffn_tile_frames.restype = i
        _lib = lib
    return _lib
