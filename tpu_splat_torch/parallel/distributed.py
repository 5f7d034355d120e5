"""Process-group setup for multi-device training (port of `tpu_splat/parallel/distributed.py`).

One process per rank, PyTorch's idiom and the counterpart of the JAX multi-controller
recipe:

  1. every process calls `initialize()`: the coordinator, the number of processes and this
     process's index come from the arguments, else from TPU_SPLAT_COORDINATOR /
     TPU_SPLAT_NUM_PROCESSES / TPU_SPLAT_PROCESS_ID, else from torchrun's MASTER_ADDR /
     MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK. With none of them set it is a world of
     one process, and no process group is made;
  2. `global_mesh(runtime, data=...)` builds the ("data", "gauss") mesh over the ranks;
  3. each data group feeds only its own cameras of the batch (`local_batch_slice`).

The backend is NCCL when each rank has a card of its own, and gloo only when asked for by
name (`backend="gloo"`: the CPU, or ranks sharing one card); no backend is chosen by
catching an error. `python -m tpu_splat_torch.parallel.dryrun` runs N gloo processes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.log import get_logger
from .mesh import Mesh, make_mesh

log = get_logger(__name__)

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Runtime:
    """This process's rank, the world's size, and the device the rank computes on."""

    rank: int
    world: int
    device: torch.device


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> Runtime:
    """Join the process group of this run (a world of 1 when nothing names one).

    `coordinator_address` is "host:port"; `device` the rank's device: in a world of
    several, the CUDA card `cuda:{LOCAL_RANK}` when None or "cuda", as given when it names
    an index ("cuda:0" for ranks that share a card), or "cpu"; in a world of 1 as
    `device.resolve_device` reads it (None: the CUDA card, raising without one).
    `backend`: "nccl" (the default on CUDA: it needs a card a rank) or "gloo" (the
    default on the CPU)."""
    coordinator_address = (coordinator_address or os.environ.get("TPU_SPLAT_COORDINATOR")
                           or _torchrun_address())
    if num_processes is None:
        num_processes = _env_int("TPU_SPLAT_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("TPU_SPLAT_PROCESS_ID", "RANK")
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = 0 if process_id is None else process_id
    world = num_processes or 1
    if world == 1:
        return Runtime(rank=0, world=1, device=resolve_device(device))
    dev = _rank_device(device, local_rank)
    if coordinator_address is None or process_id is None:
        raise ValueError(f"a world of {world} processes needs a coordinator address and "
                         "this process's index (arguments, TPU_SPLAT_* or torchrun's "
                         "variables)")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device; pass backend='gloo' on "
                             "the CPU")
        if torch.cuda.device_count() <= local_rank:
            raise RuntimeError(f"nccl needs a card a rank: local rank {local_rank} of "
                               f"{torch.cuda.device_count()} cards; pass backend='gloo' "
                               "for ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=process_id)
    log.info("distributed: rank %d/%d on %s (%s)", process_id, world, dev, backend)
    return Runtime(rank=process_id, world=world, device=dev)


def _torchrun_address() -> str | None:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _rank_device(device, local_rank: int) -> torch.device:
    if device is None or str(device) == "cuda":
        return resolve_device(f"cuda:{local_rank}")
    return resolve_device(device)


def shutdown() -> None:
    """Leave the process group (a no-op in a world of 1)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(runtime: Runtime, data: int = 1) -> Mesh:
    """The ("data", "gauss") mesh over every rank of the run."""
    return make_mesh(runtime.world, data=data, rank=runtime.rank)


def local_batch_slice(batch: int, mesh: Mesh) -> slice:
    """The cameras of the global batch that this rank's data group renders."""
    if batch % mesh.data:
        raise ValueError(f"global batch {batch} not divisible by mesh data={mesh.data}")
    b = batch // mesh.data
    return slice(mesh.d * b, (mesh.d + 1) * b)
