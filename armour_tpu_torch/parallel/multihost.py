"""Multi-host scale-out: the scenario farm over many processes and nodes.

Port of `armour_tpu/parallel/multihost.py` on ``torch.distributed``:

- `init_distributed` starts the process group (NCCL on CUDA, gloo on the
  CPU) from explicit arguments or the standard ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` environment; without either it stays a
  single process.
- `global_planner_mesh` builds the (dp, cp) mesh over every rank, refusing
  a cp group that would span nodes: the cp all-gathers run every
  Gauss-Newton iteration and belong on the node's own links, while only the
  world axis and the final summary cross nodes.
- `scatter_worlds` / `gather_summary` hand each rank its dp rows and
  collect per-world outcomes back to every rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.parallel.mesh import make_planner_mesh, mesh_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
):
    """Start the process group; returns (world size, rank).

    Pass the coordinator "host:port", the process count and this process's
    id, or none of them to read the standard environment.  Without a
    cluster environment nothing starts and (1, 0) is returned.  The backend
    follows ``device`` (the card unless ``device="cpu"``): NCCL on CUDA,
    each rank on card ``LOCAL_RANK`` (else rank modulo the card count);
    gloo on the CPU.
    """
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        if not all(k in os.environ for k in _ENV):
            return 1, 0
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(a is None for a in explicit):
        raise ValueError("init_distributed: pass coordinator_address, num_processes "
                         "and process_id together, or none of them")
    else:
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    return dist.get_world_size(), dist.get_rank()


def global_planner_mesh(cp_size: int = 1, device=None) -> DeviceMesh:
    """(dp, cp) mesh over every rank, nodes outermost in dp, so a cp group
    is consecutive ranks of one node.  The ranks of a node are
    ``LOCAL_WORLD_SIZE`` (as a launcher sets it; the whole world when it is
    unset), which ``cp_size`` must divide."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        dist.get_world_size() if dist.is_initialized() else 1)
    if local % cp_size:
        raise ValueError(
            f"cp_size={cp_size} does not divide the {local} ranks of a node; "
            "cp groups would span nodes")
    return make_planner_mesh(cp_size, device)


def scatter_worlds(mesh: DeviceMesh, *arrays):
    """This rank's dp rows of each global world array (equal leading-axis
    chunks in dp order), as tensors on the rank's device."""
    dp, i = mesh.size(0), mesh.get_local_rank("dp")
    dev = mesh_device(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % dp:
            raise ValueError(f"batch {t.shape[0]} is not divisible by dp={dp}")
        out.append(t.chunk(dp, dim=0)[i].to(dev))
    return tuple(out)


def _gather(x: torch.Tensor, group) -> np.ndarray:
    x = torch.as_tensor(x)
    is_bool = x.dtype == torch.bool
    x = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=0).cpu().numpy()
    return out.astype(bool) if is_bool else out


def gather_summary(tree, mesh: DeviceMesh):
    """All-gather per-world outcome tensors (a dict, tuple or NamedTuple of
    them, leading axis = this rank's worlds) over this rank's dp group of
    ``mesh`` (the cp ranks of a dp shard hold the same plans), as numpy
    arrays with one row per world in dp order."""
    group = mesh.get_group("dp")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return _gather(node, group)

    return walk(tree)
