"""Process groups and the data mesh (counterpart of
``rslo_tpu/train/distributed.py``).

JAX runs one controller over a mesh of every chip.  The port runs one
process per card, launched by ``torchrun`` or SLURM, and the mesh's
"data" axis is the default ``torch.distributed`` process group: NCCL
when the processes drive cards, gloo when they run on the CPU (or when a
caller asks for it by name, to put two ranks on one card).  No path
swaps one backend for the other when the first fails.  A process with
no distributed environment forms no group and computes what one card
computes.

    torchrun --nproc_per_node 8 -m rslo_tpu_torch.cli train --config C --model_dir D
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

from ..utils.mesh_axis import gather_bits

SLURM_PORT = 8898       # the coordinator port JAX's SLURM path uses


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """Where and as whom this process joins the group: ``init_method``
    (``tcp://host:port`` or a ``file://`` path), the world size, this
    process's rank and its rank on its host (its card's index)."""
    init_method: str
    world_size: int
    rank: int
    local_rank: int


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The "data" axis in the port's terms (JAX's ``Mesh``): the process
    group (None for one process without a group), this process's rank,
    the number of ranks and the device this process drives."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def resolve_rendezvous(env: Mapping[str, str],
                       coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None
                       ) -> Optional[Rendezvous]:
    """The group this process should join, or None for a single process.
    In order: the explicit arguments; SLURM's environment, parsed as the
    JAX package parses it (more than one task: the head node of
    ``SLURM_NODELIST`` at port 8898, rank ``SLURM_PROCID``); torchrun's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` (any world
    size, 1 included: JAX's ``jax.distributed.initialize()`` defaults);
    otherwise none.  The card is ``LOCAL_RANK`` (SLURM:
    ``SLURM_LOCALID``), 0 when unset."""
    local = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", 0)))
    if coordinator is None and "SLURM_NTASKS" in env:
        n = int(env["SLURM_NTASKS"])
        if n > 1:
            nodes = env["SLURM_NODELIST"]
            head = nodes.split(",")[0].replace("[", "").split("-")[0]
            coordinator = f"{head}:{SLURM_PORT}"
            num_processes = n
            process_id = int(env["SLURM_PROCID"])
    if coordinator is None and "RANK" in env and "WORLD_SIZE" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if coordinator is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    return Rendezvous(_init_method(coordinator), int(num_processes),
                      int(process_id), local)


def _device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda", backend: Optional[str] = None
                         ) -> bool:
    """Join the default process group that ``resolve_rendezvous`` names
    (NCCL on a card, gloo on the CPU, unless ``backend`` names one) and
    pin this process's card.  No-ops when a group exists or when the
    process runs alone.  A group that cannot form raises.  Returns True
    when this call formed the group (its caller destroys it)."""
    if dist.is_initialized():
        return False
    rdv = resolve_rendezvous(os.environ, coordinator, num_processes,
                             process_id)
    if rdv is None:
        return False
    dev = _device(device, rdv.local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=rdv.init_method, world_size=rdv.world_size,
        rank=rdv.rank)
    return True


def global_data_mesh(device="cuda") -> DataMesh:
    """One "data" axis over every rank of the default group (a single
    rank without one), this process on ``device`` (a card: the one
    ``initialize_multihost`` pinned).  JAX's ``train/loop.py::data_mesh``
    is this too: a process group always spans every rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return DataMesh(None, 0, 1, dev)
    return DataMesh(dist.group.WORLD, dist.get_rank(),
                    dist.get_world_size(), dev)


def local_device_count() -> int:
    """The cards this process drives: one (a process per card)."""
    return 1


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_local_batch_to_global(batch: dict, mesh: DataMesh) -> dict:
    """This process's rows of the global batch on its device.  The global
    batch is the union of every rank's rows and is never assembled: each
    rank's step reads only its own."""
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True)
            for k, v in batch.items() if k != "meta"}


def pmean_(tensors: Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """Average the float tensors over the mesh's ranks in place (JAX's
    ``pmean``: the sum over the ranks, then / size), one all-reduce per
    dtype over a flat copy.  The collective hands every rank the same
    sum, so every rank gets the same bits."""
    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
    _flat_collective(tensors, mean)


def broadcast_(tensors: Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """Overwrite the tensors with rank 0's in place, one broadcast per
    dtype over a flat copy."""
    src = dist.get_global_rank(mesh.group, 0)
    _flat_collective(tensors, lambda flat: dist.broadcast(
        flat, src, group=mesh.group))


def all_gather(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x`` in rank order, on ``x``'s device
    (``x[None]`` without a process group), through
    ``utils/mesh_axis.py::gather_bits``: each rank writes the bits of its
    elements into a zero-filled buffer that an integer all-reduce sums
    (gloo's all_gather takes no CUDA tensor), so every value, -0.0 and
    NaN included, arrives unchanged."""
    if mesh is None or mesh.group is None:
        return x[None]
    return gather_bits(x, mesh.group, mesh.rank, mesh.size)


def _flat_collective(tensors: Iterable[torch.Tensor], collective):
    """``collective`` on one flat copy of the tensors per dtype, copied
    back."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        collective(flat)
        with torch.no_grad():
            for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(v.view_as(t))
