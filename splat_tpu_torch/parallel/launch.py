"""Start one worker per rank of a mesh.

`launch(fn, world, args, device)` runs `fn(rank, world, device, *args)` on
every rank (CUDA unless `device` says otherwise) with `torch.distributed` initialized (`sharding.init_distributed`:
NCCL on CUDA, one card per rank; gloo on the CPU) and tears the process group
down after it:

  * under `torchrun` (RANK / WORLD_SIZE in the environment) this process is
    one rank: the process group comes from the environment and `world` must
    be torchrun's;
  * otherwise one rank runs in this process, or `torch.multiprocessing.spawn`
    starts `world` of them, meeting at a `file://` rendezvous in a fresh
    temporary directory (no TCP port to agree on, so concurrent launches on
    one host do not collide).

`cli.fit --mesh.enabled True` and the sharded tests call it alike.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharding import init_distributed


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def ranks_available(device: str | torch.device) -> int:
    """The ranks a mesh may use: torchrun's WORLD_SIZE, else the visible
    cards for CUDA, else 1 (a CPU mesh takes its ranks from torchrun)."""
    if under_torchrun():
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a CUDA mesh needs a CUDA device; none is visible")
        return n
    return 1


def _device(device_type: str, local_rank: int) -> torch.device:
    if device_type != "cuda":
        return torch.device(device_type)
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} has no card of its own "
                           f"({torch.cuda.device_count()} visible): NCCL needs one card per rank")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def _worker(local_rank: int, fn, args: tuple, device_type: str, world: int,
            init_method: str | None, rank: int | None):
    dev = _device(device_type, local_rank)
    if init_method is not None and device_type != "cuda":
        # every rank of a local launch is on this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rank = local_rank if rank is None else rank
    if init_method is None:
        ok = init_distributed(device=dev)
    else:
        ok = init_distributed(init_method=init_method, world_size=world, rank=rank, device=dev)
    if not ok:
        raise RuntimeError("torch.distributed did not start")
    try:
        return fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, args: tuple = (), device: str | torch.device | None = None):
    """fn(rank, world, device, *args) on `world` ranks, on CUDA unless the
    caller asks otherwise (`device.resolve_device`); returns rank 0's result
    when it ran in this process (one rank, or under torchrun), else None. fn
    must be importable by name (a module-level function) when the ranks are
    spawned."""
    device_type = resolve_device(device).type
    if under_torchrun():
        started = int(os.environ["WORLD_SIZE"])
        if started != world:
            raise ValueError(f"the mesh has {world} ranks; torchrun started {started}")
        return _worker(int(os.environ.get("LOCAL_RANK", 0)), fn, args, device_type, world,
                       None, int(os.environ["RANK"]))
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"the mesh has {world} ranks and {torch.cuda.device_count()} cards "
                           "are visible: NCCL needs one card per rank")
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        if world == 1:
            return _worker(0, fn, args, device_type, 1, init, 0)
        torch.multiprocessing.spawn(_worker, args=(fn, args, device_type, world, init, None),
                                    nprocs=world, join=True)
    return None
