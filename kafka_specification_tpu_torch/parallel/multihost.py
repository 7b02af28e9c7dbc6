"""Processes, shards and collectives of the sharded engine (torch.distributed).

The counterpart of ``kafka_specification_tpu/parallel/multihost.py``.  The
controller model is the JAX package's REPLICATED HOST LOOP: every process
runs the same deterministic loop over the same host-side data (every
shard's pending rows, the level counts, the chunk plan), so control
decisions agree everywhere without a coordinator.  Each process expands
and dedups only the shards it owns; what the loop needs of the others it
reads with :func:`fetch_global` (an all-gather), and the candidate
exchange routes each candidate to its owner with :func:`all_to_all_shards`
(or :func:`all_gather_shards`).

- ``init_distributed`` joins the process group: torchrun's variables
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) or
  ``KSPEC_MULTIHOST=1`` (alone: a one-process group on localhost).  NCCL
  for a CUDA device, gloo for the CPU.
- :class:`ShardMesh` stands in for ``jax.sharding.Mesh``: D shards, each
  with its process and its ``torch.device``.  Several shards may share one
  device (D logical shards on ``cuda:0``, or on the CPU in the tests; a
  CPU process's default mesh holds ``$KSPEC_CPU_SHARDS_PER_PROC`` of
  them, as XLA's forced host device count gives a JAX CPU process).
  Shards go to processes in contiguous equal blocks, as a JAX mesh of
  ``jax.devices()`` lays them out.

When a process group exists, every exchange, every ``fetch_global`` and
every ``or_across_processes`` goes through it, even at world size 1: that
is how one card runs the NCCL route.  Without a group they are local
(a transpose, a stack, the identity).  Values ride the wire as int32 or
int64 tensors: gloo refuses ``torch.uint32`` in a collective, and the
port keeps u32 lanes in int64 tensors anyway.
"""

from __future__ import annotations

import atexit
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.bfs import resolve_device

MULTIHOST_ENV = "KSPEC_MULTIHOST"
#: shards each process of a CPU mesh holds in ``ShardMesh.default`` (the
#: counterpart of XLA's ``--xla_force_host_platform_device_count``, which
#: the JAX package's CPU fleets use; read on the CPU only)
CPU_SHARDS_ENV = "KSPEC_CPU_SHARDS_PER_PROC"


def _dist():
    import torch.distributed as dist

    return dist


def group_active() -> bool:
    """True when this process has joined a process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if group_active() else 1


def process_index() -> int:
    return _dist().get_rank() if group_active() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_coordinator() -> bool:
    """True on the process that performs singleton side effects
    (checkpoint mains, stats files, the parent log's epochs)."""
    return process_index() == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None, addr: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> dict:
    """Join the process group when one is configured; a no-op otherwise.

    Explicit arguments win; else torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` drive it.  ``KSPEC_MULTIHOST=1`` with no address
    joins a one-process group on localhost (the JAX package's degenerate
    launch).  The backend is NCCL when `device` (default: the card when
    CUDA is there) is a CUDA device, else gloo; a CUDA process binds
    ``cuda:$LOCAL_RANK`` (else its rank modulo the visible cards).
    Re-entry is idempotent.  -> {"process_id", "process_count",
    "local_devices", "global_devices"}."""
    dist = _dist()
    addr = addr or os.environ.get("MASTER_ADDR")
    want = addr is not None or os.environ.get(MULTIHOST_ENV) == "1"
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if want and not group_active():
        if addr is None:
            addr, port, world_size, rank = "localhost", _free_port(), 1, 0
        else:
            port = int(os.environ.get("MASTER_PORT", "29500"))
        if world_size is None:
            world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if rank is None:
            rank = int(os.environ.get("RANK", "0"))
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{addr}:{port}",
                                world_size=world_size, rank=rank)
        # leave the group before the interpreter tears the backend down
        atexit.register(leave_distributed)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {
        "process_id": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_devices": local * process_count(),
    }


def leave_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if group_active():
        _dist().destroy_process_group()


def comm_device() -> torch.device:
    """Where the group's tensors live: the bound card under NCCL, else
    the CPU."""
    if group_active() and _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class ShardMesh:
    """D shards, each with its process and its ``torch.device``.

    `devices` (one per shard) defaults to `device` for every shard, and
    `device` to the card (``resolve_device``: the CPU only when asked for
    by name, no fallback without CUDA); shard d belongs to process ``d // (D // P)`` (P processes of
    the group, 1 without one), so D must be a multiple of P."""

    def __init__(self, shards: int, device=None, devices: Optional[Sequence] = None):
        D = int(shards)
        P = process_count()
        if D < 1 or D % P:
            raise ValueError(f"a mesh of {D} shards over {P} processes: D must be a "
                             f"positive multiple of the process count")
        per = D // P
        self.shard_proc = [d // per for d in range(D)]
        self.my_proc = process_index()
        self.my_shards = [d for d in range(D) if self.shard_proc[d] == self.my_proc]
        if devices is None:
            devices = [resolve_device(device)] * D
        if len(devices) != D:
            raise ValueError(f"{len(devices)} devices for {D} shards")
        self.devices = [torch.device(x) for x in devices]
        if group_active():
            local = {self.devices[d] for d in self.my_shards}
            if len(local) != 1:
                raise ValueError("under a process group this process's shards share one device")

    @classmethod
    def default(cls, device=None) -> "ShardMesh":
        """One shard per device the runtime exposes (the JAX rule): world
        size x the visible cards on the card; on the CPU, world size x
        $KSPEC_CPU_SHARDS_PER_PROC (default 1)."""
        dev = resolve_device(device)
        P = process_count()
        if dev.type == "cuda":
            if group_active():
                # NCCL binds one card per process
                return cls(P, device=torch.device("cuda", torch.cuda.current_device()))
            n = torch.cuda.device_count()
            return cls(n, devices=[torch.device("cuda", i) for i in range(n)])
        return cls(P * int(os.environ.get(CPU_SHARDS_ENV) or 1), device=dev)

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, d: int) -> torch.device:
        return self.devices[d]



def mesh_layouts(mesh: ShardMesh) -> dict:
    """The placement of every mesh-resident tensor class, under the JAX
    package's names and in its ``str(PartitionSpec)`` form: rows of the
    frontier, the exchange buffers and the per-shard sets ride the shard
    axis 'd'; the lanes and each shard's capacity stay with their shard."""
    rows, flat = "PartitionSpec('d', None)", "PartitionSpec('d',)"
    return {"frontier": rows, "fvalid": flat, "fpset": rows, "pershard": flat,
            "exchange": rows}


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32) if t.dtype == torch.bool else t


def _all_gather(local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` (the same shape everywhere), concatenated
    along dim 0 in process order, on the group's device."""
    dist = _dist()
    x = _wire(local).to(comm_device()).contiguous()
    out = x.new_empty((process_count() * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x)
    return out.to(torch.bool) if local.dtype == torch.bool else out


def fetch_global(local: torch.Tensor) -> np.ndarray:
    """This process's shards' values, stacked along dim 0 in shard order
    (one entry per local shard, the same shape on every process) -> the
    global array over all D shards, identical on every process."""
    if not group_active():
        return local.cpu().numpy()
    return _all_gather(local).cpu().numpy()


def stack_global(local: torch.Tensor) -> torch.Tensor:
    """This process's shards' rows, stacked along dim 0 in shard order ->
    every shard's rows [D, ...], on `local`'s device: an all-gather on the
    group's device, with no host read (fetch_global's queued half)."""
    if not group_active():
        return local
    return _all_gather(local).to(local.device)


def gather_rows(local: list, width: int, dtype=torch.int64, lens=None) -> list:
    """Per-shard tensors of different lengths (one per local shard, each
    [n, width] or [n] when `width` is 0) -> the list over all D shards, on
    the first local tensor's device.  Lengths go first (or `lens`, every
    shard's, when the caller knows them), then one gather of the rows
    padded to the longest."""
    if not group_active():
        return list(local)
    dev = local[0].device
    if lens is None:
        lens = fetch_global(torch.tensor([t.shape[0] for t in local], dtype=torch.int64))
    nmax = int(lens.max()) if lens.size else 0
    shape = (nmax, width) if width else (nmax,)
    pad = torch.zeros((len(local),) + shape, dtype=dtype, device=comm_device())
    for i, t in enumerate(local):
        pad[i, : t.shape[0]] = t.to(dtype)
    got = _all_gather(pad).to(dev)
    return [got[d, : int(n)] for d, n in enumerate(lens)]


def or_across_processes(arr: np.ndarray) -> np.ndarray:
    """Element-wise OR of a boolean array across the group (an all-reduce
    MAX over an int32 view): the host set's novelty masks, computed only
    by each shard's owner, made identical on every process."""
    if not group_active():
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(comm_device())
    _dist().all_reduce(t, op=_dist().ReduceOp.MAX)
    return t.cpu().numpy().astype(bool)


def max_across_processes(n: int) -> int:
    """The largest of each process's `n`."""
    if not group_active():
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64, device=comm_device())
    _dist().all_reduce(t, op=_dist().ReduceOp.MAX)
    return int(t.item())


def all_to_all_shards(send: list, mesh: ShardMesh) -> list:
    """The all_to_all exchange.  `send`: one int32 tensor [D, W, F] per
    local source shard (block o is what goes to owner shard o).  -> one
    [D, W, F] tensor per local owner shard, block s being what source
    shard s sent it, on the owner's device.  Without a group (every shard
    local) it is a transpose; with one, one ``all_to_all_single``."""
    D = mesh.size
    if not group_active():
        return [torch.stack([send[s][o].to(mesh.device(o)) for s in range(D)])
                for o in mesh.my_shards]
    L = len(mesh.my_shards)
    x = torch.stack(send).to(comm_device())  # [L src, D dst, W, F]
    x = x.transpose(0, 1).contiguous()  # [D dst, L src, W, F]: dst-major, process blocks
    out = torch.empty_like(x)  # [P src procs x L dst, L src, W, F]
    _dist().all_to_all_single(out, x)
    P = process_count()
    out = out.view(P, L, L, *x.shape[2:]).transpose(0, 1)  # [L dst, P, L src, W, F]
    dev = mesh.device(mesh.my_shards[0])
    return [out[i].reshape(D, *x.shape[2:]).to(dev) for i in range(L)]


def all_gather_shards(send: list, mesh: ShardMesh) -> torch.Tensor:
    """The all_gather exchange: one int32 tensor [T, F] per local source
    shard -> [D, T, F], every source shard's block, on this process's
    first shard's device."""
    dev = mesh.device(mesh.my_shards[0])
    if not group_active():
        return torch.stack([t.to(dev) for t in send])
    return _all_gather(torch.stack(send)).to(dev)
