"""Scale-out over processes: a (dp, cp) mesh and the sharded planning step.

Port of `armour_tpu/parallel/mesh.py` on ``torch.distributed``, one
process per device (NCCL on CUDA, gloo on the CPU):

- ``dp`` (data parallel): independent (world, initial-condition) planning
  problems; each dp index holds its rows of the world batch.  No
  communication.
- ``cp`` (constraint parallel): the obstacle-capacity axis of every world is
  split over the ranks of a cp group; each rank builds and passes over its
  slice of the hyperplane bank and the NLP all-gathers the collision block
  over the group (`ArmourPlanner.solve(collision_group=...)`).

The JAX package expresses this as one ``jax.jit`` of a ``shard_map``
program over a device mesh; here every rank runs the same step on its own
shard, kept per shape as a ``PlanProgram`` (CUDA graphs on a card), and
the process group carries the gathers.  Every rank of a cp group must
iterate on the same starts, or the gathered constraint vector would mix
different iterates: the step takes the group's first rank's and broadcasts
them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.planner.armour import ArmourPlanner, PlanResult
from armour_tpu_torch.robots.spec import RobotSpec


def group_device(device=None) -> torch.device:
    """The device of this rank: ``device`` if given; else the CPU under a
    gloo process group and this rank's card otherwise (raising without
    one, as every entry point)."""
    if device is None and dist.is_initialized() and dist.get_backend() == "gloo":
        device = "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_planner_mesh(cp_size: int | None = None, device=None) -> DeviceMesh:
    """A (dp, cp) mesh over the ranks of the default process group, cp
    innermost (consecutive ranks share a cp group).

    ``cp_size`` defaults to 2 when the world size is even, else 1:
    constraint parallelism only pays off for obstacle-dense scenes, so most
    ranks go to the world axis.  The mesh lives on ``group_device(device)``.
    """
    dev = group_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_planner_mesh: no process group; call "
                           "parallel.multihost.init_distributed first")
    n = dist.get_world_size()
    if cp_size is None:
        cp_size = 2 if n % 2 == 0 and n >= 2 else 1
    if n % cp_size:
        raise ValueError(f"cp_size={cp_size} does not divide the world size {n}")
    return init_device_mesh(dev.type, (n // cp_size, cp_size), mesh_dim_names=("dp", "cp"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    return group_device("cpu" if mesh.device_type == "cpu" else None)


def cp_shard(mesh: DeviceMesh, x, axis: int = 1):
    """This rank's contiguous slice of the obstacle-capacity ``axis`` of
    ``x`` (the counterpart of the JAX in_spec ``P("dp", "cp")``), as a
    tensor on the rank's device."""
    x = torch.as_tensor(x)
    cp, i = mesh.size(1), mesh.get_local_rank("cp")
    if x.shape[axis] % cp:
        raise ValueError(f"capacity {x.shape[axis]} is not divisible by cp={cp}")
    return x.chunk(cp, dim=axis)[i].to(mesh_device(mesh))


def sharded_plan_step(spec: RobotSpec, cfg: PlannerConfig, mesh: DeviceMesh,
                      dtype=torch.float32):
    """The batched planning step of one rank of a (dp, cp) mesh.

    Returns ``step(q0, qd0, qdd0, q_des, zonos, masks, k_rand=None,
    generator=None, eager=False) -> PlanResult``: each rank passes its dp
    shard of the worlds (``scatter_worlds``) and its cp shard of the
    obstacle capacity axis of ``zonos`` / ``masks`` (``cp_shard``), and gets
    the plans of its dp shard (the same on every rank of a cp group).
    ``step.planner`` is the rank's ``ArmourPlanner``.  It
    runs the Bernstein planner without grasp or self-intersection, and
    builds the bank at the shard's whole capacity: no culling and no
    bucket, so every rank's bank has one shape for the gather (as the JAX
    package's ``_make_plan_fn``).  The random starts (``k_rand`` or drawn
    from ``generator``) of the cp group's first rank are broadcast to the
    group.  The warm start is zero, as in the JAX step.

    The step is the planner's full-width plan program
    (``ArmourPlanner.run_program(full_width=True)``), kept per (B, shard
    capacity) and cp group in ``step.planner.batch_programs``, the
    counterpart of the JAX package's ``jax.jit`` of the ``shard_map``: the
    first call at a shape captures, every later call replays through the
    program's buffers.  With cp > 1 the build stays a graph and the solve,
    which gathers the collision block, runs op by op through the program's
    buffers (``ArmourPlanner.solve``).  ``eager=True`` builds and
    solves op by op with no program, to hold the two against each other.
    """
    planner = ArmourPlanner(spec, cfg, dtype, device=mesh_device(mesh))
    cp_group = mesh.get_group("cp") if mesh.size(1) > 1 else None

    def step(q0, qd0, qdd0, q_des, zonos, masks, k_rand=None,
             generator: torch.Generator | None = None, eager: bool = False) -> PlanResult:
        return planner.run_program(q0, qd0, qdd0, q_des, zonos, masks, k_rand, None, generator,
                                   full_width=True, eager=eager, collision_group=cp_group)[0]

    step.planner = planner
    return step
