"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``nbss_tpu/parallel/mesh.py``. The JAX package shards the
batch over a ``data`` mesh axis with parameters replicated, and XLA inserts
the gradient sum; here every card is a rank of a process group (NCCL across
cards, gloo on the CPU), parameters are replicated by broadcast from rank 0,
and ``DistributedDataParallel`` averages the gradients (train/loop.py).

A host's batch is split into contiguous rows, one block per local rank, so
that a step's global batch (the hosts' batches, host after host) holds the
items of the JAX package's global array in its order. A batch whose leading
dimension does not split evenly is replicated instead, as ``shard_batch``
replicates there, and on several ranks its copies are checked equal.

Where the ranks come from:

- ``launch`` starts ``local_size`` ranks on this host (processes forked
  from a fork server that imported the port; a free port found by binding
  port 0), as JAX's one process drives every local device; with a
  ``Rendezvous`` they join the ranks of the other hosts.
- ``rendezvous`` reads the multi-host contract from the environment and the
  config alone, before anything touches a device:
  ``NBSS_COORDINATOR=host:port``, ``NBSS_NUM_PROCESSES`` and
  ``NBSS_PROCESS_ID`` (one launcher process per host; global rank = process
  id x local ranks + local rank), or, with ``trainer.num_nodes > 1`` and no
  coordinator, torch's ``env://`` variables as ``torchrun`` sets them
  (``init_from_env``: this process is one rank).
"""

from __future__ import annotations

import os
import pickle
import socket
import traceback
import zlib
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# what the ranks' fork server imports before it forks them
# (torch._dynamo: a torch.optim optimizer imports it when it is made)
PRELOAD = ("torch._dynamo", "torch.nn.parallel", "nbss_tpu_torch.models",
           "nbss_tpu_torch.cli.main", "nbss_tpu_torch.data", "nbss_tpu_torch.eval.runner")
# a collective that waits longer than this fails the run instead of hanging it
COLLECTIVE_TIMEOUT = timedelta(minutes=30)


@dataclass(frozen=True)
class Mesh:
    """The ranks of a data-parallel run, as this process sees them: ``size``
    ranks in all, ``local_size`` of them on this host. A mesh of one rank has
    no process group and its collectives do nothing."""

    size: int = 1
    rank: int = 0
    local_size: int = 1
    local_rank: int = 0

    @property
    def hosts(self) -> int:
        return self.size // self.local_size

    @property
    def host(self) -> int:
        return self.rank // self.local_size

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints, logs and writes."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor; ``t`` itself on one)."""
        if self.size == 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t)
        return t / self.size

    def all_gather_object(self, obj: Any) -> List[Any]:
        if self.size == 1:
            return [obj]
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


_CURRENT = Mesh()


def current_mesh() -> Mesh:
    """The mesh of this process: one rank unless ``launch`` or ``init_from_env``
    made it a rank of a group."""
    return _CURRENT


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The process group of this run as a ``Mesh`` (of one rank when there is
    no group). Unlike JAX, one process cannot build a group of n devices: a
    run of n ranks is started by ``launch``, so ``n_devices`` must be None or
    the group's size."""
    if n_devices not in (None, _CURRENT.size):
        raise ValueError(f"this process is a rank of a group of {_CURRENT.size}, not "
                         f"{n_devices}; start n ranks with nbss_tpu_torch.parallel.launch")
    return _CURRENT


class Shard(tuple):
    """A batch as one rank holds it: its rows of the host batch, or, with
    ``replicated``, the whole of a batch that did not split into equal rows."""

    replicated: bool = False

    def __new__(cls, batch, replicated: bool = False):
        self = super().__new__(cls, batch)
        self.replicated = replicated
        return self

    @staticmethod
    def like(batch, values) -> tuple:
        """``values`` as a Shard with ``batch``'s flag when ``batch`` is one."""
        return Shard(values, batch.replicated) if isinstance(batch, Shard) else tuple(values)


def rows(n: int, ranks: int, rank: int) -> Optional[slice]:
    """This rank's contiguous rows of a host batch of ``n``, or None when the
    batch does not split into equal blocks (then every rank takes it whole)."""
    if n % ranks:
        return None
    k = n // ranks
    return slice(rank * k, (rank + 1) * k)


def shard_batch(mesh: Mesh, batch) -> Shard:
    """This rank's rows of a host batch (x, ys, ...) as a ``Shard``; a batch
    whose leading dimension does not split over the host's ranks is replicated,
    and on several ranks its copies are checked equal first. A ``Shard`` is
    returned as it is."""
    if isinstance(batch, Shard):
        return batch
    if mesh.local_size == 1 and mesh.hosts == 1:
        return Shard(batch)
    sl = rows(len(batch[0]), mesh.local_size, mesh.local_rank)
    if sl is None:
        _assert_same_across_processes(mesh, batch[0])
        return Shard(batch, replicated=True)
    return Shard(b[sl] if b is not None else None for b in batch)


def _assert_same_across_processes(mesh: Mesh, x) -> None:
    """Raise if ``x`` differs between ranks (crc32 of its bytes, gathered by
    one small collective). Runs only for a replicated batch."""
    if mesh.size == 1:
        return
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    crc = zlib.crc32(np.ascontiguousarray(a).tobytes())
    gathered = mesh.all_gather_object(crc)
    if any(c != gathered[0] for c in gathered):
        raise ValueError(f"replicated batch differs across ranks (checksums {gathered}); "
                         "ragged val/test batches must be seed-identical on every host: "
                         "check the sampler seeds")


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank (in place),
    one flat tensor a dtype."""
    if mesh.size > 1:
        tensors = list(module.parameters()) + list(module.buffers())
        with torch.no_grad():
            for dtype in dict.fromkeys(t.dtype for t in tensors):
                group = [t for t in tensors if t.dtype == dtype]
                flat = torch.cat([t.reshape(-1) for t in group])
                dist.broadcast(flat, src=0)
                for t, v in zip(group, flat.split([t.numel() for t in group])):
                    t.copy_(v.view_as(t))
    return module


# ------------------------------------------------------------------ ranks


@dataclass(frozen=True)
class Rendezvous:
    """Where this host's ranks meet the others: ``address`` host:port of
    rank 0's store, ``hosts`` launcher processes, this one ``host``; or
    ``torchrun``: this process is already one rank (env:// variables)."""

    address: Optional[str]
    hosts: int
    host: int
    torchrun: bool = False


def rendezvous(num_nodes: int = 1) -> Optional[Rendezvous]:
    """The multi-host contract, from the environment and ``num_nodes`` alone
    (nothing touches a device): None for a one-host run. Raises when
    ``num_nodes`` > 1 and neither contract is set."""
    coord = os.environ.get("NBSS_COORDINATOR")
    if coord:
        try:
            hosts = int(os.environ["NBSS_NUM_PROCESSES"])
            host = int(os.environ["NBSS_PROCESS_ID"])
        except KeyError as e:
            raise ValueError(f"NBSS_COORDINATOR={coord} needs NBSS_NUM_PROCESSES and "
                             f"NBSS_PROCESS_ID; {e.args[0]} is not set") from None
        if not 0 <= host < hosts:
            raise ValueError(f"NBSS_PROCESS_ID={host} outside [0, {hosts})")
        return Rendezvous(coord, hosts, host)
    if num_nodes <= 1:
        return None
    if all(v in os.environ for v in _TORCHRUN_VARS):
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        return Rendezvous(None, int(os.environ["WORLD_SIZE"]) // local,
                          int(os.environ["RANK"]) // local, torchrun=True)
    raise ValueError(
        f"trainer.num_nodes={num_nodes} but no rendezvous is set: give every host "
        "NBSS_COORDINATOR=host:port, NBSS_NUM_PROCESSES and NBSS_PROCESS_ID (one launcher "
        "process per host), or start one process per card with torchrun, which sets "
        f"{', '.join(_TORCHRUN_VARS)} and LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init(backend: str, init_method: str, size: int, rank: int, local_size: int,
          local_rank: int, device: Optional[str]) -> Mesh:
    global _CURRENT
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))  # the ctypes kernels launch on it
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    _CURRENT = Mesh(size, rank, local_size, local_rank)
    # every host must start as many ranks: the global ranks assume it
    sizes = _CURRENT.all_gather_object(local_size)
    if len(set(sizes)) != 1:
        raise ValueError(f"hosts started different numbers of ranks: {sizes}")
    return _CURRENT


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _CURRENT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT = Mesh()


def init_from_env(backend: str, device_type: str = "cuda") -> Mesh:
    """Make this process the rank that torch's env:// variables name (as
    ``torchrun`` sets them); on CUDA it takes card ``LOCAL_RANK``."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = f"cuda:{local_rank}" if device_type == "cuda" else None
    return _init(backend, "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                 int(os.environ.get("LOCAL_WORLD_SIZE", "1")), local_rank, device)


def _context():
    """Ranks fork from a server that has imported the port once (and touched
    no card): a rank starts in about a second instead of importing anew."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    return ctx


def start_fork_server() -> None:
    """Start the fork server ``launch`` forks ranks from, so that its imports
    run beside the caller's work instead of at the first launch."""
    import multiprocessing.forkserver as fs

    _context()
    fs.ensure_running()


def stop_fork_server() -> None:
    """Stop the fork server ``launch`` started and multiprocessing's resource
    tracker, where they run (both also stop by themselves once this process
    has exited)."""
    import multiprocessing.forkserver as fs
    import multiprocessing.resource_tracker as rt

    for server, pid in ((getattr(fs, "_forkserver", None), "_forkserver_pid"),
                        (getattr(rt, "_resource_tracker", None), "_pid")):
        if server is not None and getattr(server, pid, None) is not None and \
                hasattr(server, "_stop"):
            server._stop()


def _rank_main(fn, args, backend, init_method, size, rank, local_size, local_rank, device,
               threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        _init(backend, init_method, size, rank, local_size, local_rank, device)
        try:
            out = fn(*args)
        finally:
            shutdown()
        # pickled here, by value: a tensor is not left in this process's shared
        # memory, and an unpicklable result fails in the rank, not in the queue's thread
        results.put((local_rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the launcher, which raises it
        results.put((local_rank, False, traceback.format_exc()))


def launch(fn: Callable, args: Sequence = (), local_size: int = 1, backend: str = "gloo",
           devices: Optional[Sequence[Optional[str]]] = None,
           rdv: Optional[Rendezvous] = None, timeout: Optional[float] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``local_size`` new ranks of one process group and
    return their results in local-rank order. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function). ``devices`` names each local rank's card
    (None: the CPU); ``rdv`` joins other hosts' ranks; ``threads`` sets each
    rank's torch threads. A rank that raises, or a run past ``timeout``
    seconds, stops every rank and raises here. As with any spawned process,
    the caller's main module must be safe to import (its work under
    ``if __name__ == "__main__"``): each rank imports it."""
    import queue as queue_mod
    import time

    if rdv is not None and rdv.torchrun:
        raise ValueError("under torchrun every process is a rank: use init_from_env")
    hosts, host = (rdv.hosts, rdv.host) if rdv is not None else (1, 0)
    address = rdv.address if rdv is not None else f"127.0.0.1:{free_port()}"
    devices = list(devices) if devices is not None else [None] * local_size
    if len(devices) != local_size:
        raise ValueError(f"{len(devices)} devices for {local_size} ranks")
    ctx = _context()
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=False, name=f"nbss-rank{host * local_size + r}",
                         args=(fn, tuple(args), backend, f"tcp://{address}", hosts * local_size,
                               host * local_size + r, local_size, r, devices[r], threads,
                               results))
             for r in range(local_size)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * local_size
    pending = set(range(local_size))
    deadline = None if timeout is None else time.monotonic() + timeout
    error = None
    try:
        while pending and error is None:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                error = f"ranks {sorted(pending)} still running after {timeout:.0f} s"
                break
            try:
                r, ok, value = results.get(timeout=1.0 if left is None else min(1.0, left))
            except queue_mod.Empty:
                dead = [r for r in pending if not procs[r].is_alive()
                        and procs[r].exitcode not in (None, 0)]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                continue
            pending.discard(r)
            if ok:
                out[r] = pickle.loads(value)
            else:
                error = f"rank {host * local_size + r} failed:\n{value}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if error is not None:
        raise RuntimeError(error)
    return out
