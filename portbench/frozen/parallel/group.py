"""Process groups for the multi-device path: the port's counterpart of the
`jax.sharding.Mesh` that dynosam_tpu/parallel/batched.py (`mesh=`, the
sequence axis) and dynosam_tpu/parallel/sharded.py (the landmark axis) take.

The reference runs one SPMD program over a mesh of devices. The port runs
one process per device (a rank), each issuing its own card's work from its
own Python thread, and joins them with `torch.distributed`:

  * one process per device, not one process driving several: the step is
    bound by host dispatch (thousands of small eager ops per frame, the card
    idle most of the step), so one host thread issuing for several cards
    would serialise exactly the part that bounds it;
  * NCCL between cards; gloo on the CPU, and wherever several ranks share
    one card (NCCL refuses two ranks on one GPU). gloo takes CUDA tensors
    in all_reduce and broadcast but not in gather, so `gather_to_rank0`
    goes through host copies there.

`spawn(fn, world, device, backend)` starts `world` ranks with a TCP
rendezvous on a free local port and returns what each rank's
`fn(group, *args)` returned. A rank that raises ends the run: the others
are stopped and the exception is raised in the caller.
"""

from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600


@dataclass
class Group:
    """A rank's view of its process group: its rank, the world size, its
    `torch.device` and the `torch.distributed` group."""
    rank: int
    world: int
    device: torch.device
    backend: str
    pg: object


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(backend: str, rank: int, world: int, init_method: str, device="cuda") -> Group:
    """Join the group as `rank` of `world`. On the card each rank takes card
    `rank % device_count`; a rank that finds no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device")
        count = torch.cuda.device_count()
        torch.cuda.set_device(rank % count)
        dev = torch.device("cuda", rank % count)
        if backend == "nccl" and world > count:
            raise ValueError(f"NCCL refuses two ranks on one GPU: {world} ranks over {count} card(s); use gloo")
    elif backend == "nccl":
        raise ValueError(f"NCCL needs CUDA devices, not {dev}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return Group(rank=rank, world=world, device=dev, backend=backend, pg=dist.group.WORLD)


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """`t` summed over the group's ranks, in place; returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    return t


def broadcast(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """`t` overwritten with rank `src`'s, in place; returns `t` (bool
    tensors travel as their bytes)."""
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=src, group=group.pg)
    return t


def gather_to_rank0(t: torch.Tensor, group: Group) -> Optional[List[torch.Tensor]]:
    """Every rank's `t` (all of one shape) -> on rank 0 the list in rank
    order, on `t`'s device; None elsewhere. gloo gathers host copies."""
    host = group.backend == "gloo" and t.device.type != "cpu"
    x = (t.detach().cpu() if host else t.detach()).contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    bufs = [torch.empty_like(x) for _ in range(group.world)] if group.rank == 0 else None
    dist.gather(x, gather_list=bufs, dst=0, group=group.pg)
    return None if bufs is None else [b.view(t.dtype).to(t.device) for b in bufs]


def max_diff_from_rank0(t: torch.Tensor, group: Group) -> float:
    """The largest |t - rank 0's t| on this rank (rank 0's broadcast)."""
    ref = broadcast(t.detach().clone(), group, 0)
    return float((t - ref).abs().max()) if t.numel() else 0.0


def free_port() -> int:
    """A free local TCP port, taken by binding port 0."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(obj):
    """`obj` with every tensor in it (in dicts, lists and tuples) as a numpy
    array, for a rank's return value."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank, fn, world, device, backend, init_method, args, queue, threads):
    if threads:
        torch.set_num_threads(threads)
    group = init_group(backend, rank, world, init_method, device)
    try:
        queue.put((rank, to_host(fn(group, *args))))
        dist.barrier(group=group.pg)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device="cuda", backend: Optional[str] = None, args=(),
          threads: Optional[int] = None) -> list:
    """Run `fn(group, *args)` in `world` new processes, one per rank, and
    return their results in rank order (tensors as numpy arrays). `fn` must
    be importable by name (a module's top-level function); `args` are
    pickled to every rank (CPU tensors only). `threads` sets each rank's
    torch thread count. A rank that raises stops the others, and its
    exception is raised here."""
    backend = backend or default_backend(device)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, str(device), backend, init_method, args, queue, threads),
        nprocs=world, join=False, start_method="spawn")
    results = {}

    def drain():
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out

    while not procs.join(timeout=0.2):
        drain()
    drain()
    missing = sorted(set(range(world)) - set(results))
    if missing:
        raise RuntimeError(f"ranks {missing} returned nothing")
    return [results[r] for r in range(world)]

