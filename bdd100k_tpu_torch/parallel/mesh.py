"""The data-parallel layout (counterpart of bdd100k_tpu/parallel/mesh.py).

The reference runs one program over a ('data', 'model') mesh of devices;
the port runs one process per GPU, as torch does, joined by
`torch.distributed`: the data axis is the process group, a rank's device
is `cuda:LOCAL_RANK`, and the model axis is always 1. `init_distributed`
reads the environment `torchrun` sets (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK) and joins the default group: NCCL for CUDA,
gloo for the CPU. Beside it a gloo group carries the host's own traffic
(barriers, object broadcasts), so that a file barrier never needs the card.

Without `init_distributed` there is one process: rank 0 of 1, every
barrier a no-op.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)  # a missing peer fails, not hangs

_host_group = None


def init_distributed(device: str | torch.device) -> torch.device:
    """Join the process group that the environment names → this rank's
    device (`cuda:LOCAL_RANK`, or the CPU). A missing variable raises
    with its name."""
    device = torch.device(device)
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
               if k not in os.environ]
    if missing:
        raise SystemExit(
            f"--multihost needs {', '.join(missing)} in the environment "
            "(torchrun --nproc_per_node N sets them)")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    global _host_group
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", timeout=TIMEOUT)
        _host_group = (dist.new_group(backend="gloo", timeout=TIMEOUT)
                       if device.type == "cuda" else dist.group.WORLD)
    return device


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def data_rank() -> int:
    """This process's place on the data axis."""
    return dist.get_rank() if is_distributed() else 0


def data_size() -> int:
    """The data axis's length: the number of processes."""
    return dist.get_world_size() if is_distributed() else 1


def train_group():
    """The group a train step reduces over: the default group once
    `init_distributed` ran, else None (one process, no collectives)."""
    return dist.group.WORLD if is_distributed() else None


def barrier() -> None:
    """Wait for every rank, on the host group; a no-op in one process."""
    if is_distributed():
        dist.barrier(group=_host_group)


def broadcast_object(obj, src: int = 0):
    """`obj` as rank `src` holds it, on every rank (pickled over the host
    group)."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group)
    return box[0]


def resolve_mesh_data(mesh_data: int | None) -> int:
    """--mesh_data → the data axis's length. None means every process;
    any other value must equal the world size, as the reference's mesh
    refuses to need more devices than it has."""
    n = data_size()
    if mesh_data is None or mesh_data == n:
        return n
    raise SystemExit(
        f"--mesh_data {mesh_data} asks for a data axis of {mesh_data}, but "
        f"the world has {n} process(es): the port's data axis is one "
        "process per GPU, so --mesh_data must equal the world size")


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _host_group
    if is_distributed():
        dist.destroy_process_group()
    _host_group = None
