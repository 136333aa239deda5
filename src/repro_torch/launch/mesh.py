"""Device meshes of sharded rounds (counterpart of
``repro/launch/mesh.py``, reduced to what the port runs).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with dims
``("agent", "model")`` over one process per rank; its dims' process
groups are the agent group (the ranks that hold one row block each) and
the model group (the ranks that split one row block's columns and each
agent's batch: :mod:`repro_torch.fed.sharding`).  The backend is NCCL on
``cuda`` (one rank per card, ``cuda:LOCAL_RANK``) and gloo on ``cpu``.
Processes come from ``python -m torch.distributed.run`` (torchrun), whose
environment names the world; a caller may also create the default
process group itself before asking for a mesh, and then its backend is
the mesh's: the multi-process tests do so over a ``FileStore`` with gloo
on the CPU, and ``chip_smoke.py`` puts several gloo ranks on its one
card, each passing ``device="cuda:0"`` (an explicit index is kept).  A
1x1 mesh needs neither: without a process group one single-process group
is created on an in-memory store, with no port and no file.  Meshes are
cached per (shape, device), so every trainer of a run shares one.

The reference's production meshes (256 and 512 TPU chips, ``pod`` /
``data`` axes) are TPU layouts and are not carried over.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

MESH_DIMS = ("agent", "model")

# one mesh per (process group, shape, device): building a mesh creates
# its dims' process groups (a collective), and every trainer of a run
# shares the one world
_MESHES: dict = {}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _ensure_world(agents: int, model: int, device: torch.device) -> None:
    """Join (or create) the default process group and check that it
    holds exactly ``agents * model`` ranks."""
    need = agents * model
    launch = (f"launch one process per rank with `python -m "
              f"torch.distributed.run --standalone --nproc-per-node "
              f"{need} ...` (torchrun)")
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:            # started by torchrun
            dist.init_process_group(_backend(device))
        elif need == 1:
            dist.init_process_group(_backend(device), store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"mesh of {agents}x{model} needs {need} devices, but no "
                f"process group is running -- {launch}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"mesh of {agents}x{model} needs {need} devices, but the "
            f"process group has {world} -- {launch}")


def mesh_device(device) -> torch.device:
    """This rank's device: a CUDA device with an explicit index as it is
    (ranks that share a card name it), else ``cuda:LOCAL_RANK`` for a
    CUDA run -- one rank per card, so a local rank without a card of its
    own raises -- and the device itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank = int(os.environ.get("LOCAL_RANK", 0))
    if rank >= torch.cuda.device_count():
        raise ValueError(
            f"local rank {rank} has no card of its own ({torch.cuda.device_count()} "
            f"visible): a CUDA mesh runs one rank per card (start at most "
            f"that many processes per node)")
    return torch.device("cuda", rank)


def make_fed_mesh(agents: int = 1, model: int = 1, *, device="cuda"):
    """The ``(agent, model)`` round mesh of ``agents * model`` ranks on
    ``device``'s type (raises, naming torchrun, when the world does not
    have that many ranks)."""
    if agents < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got {agents}x{model}")
    device = mesh_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _ensure_world(agents, model, device)
    key = (agents, model, str(device))
    world, mesh = _MESHES.get(key, (None, None))
    if world is not dist.group.WORLD:       # none yet, or a group since ended
        mesh = init_device_mesh(device.type, (agents, model),
                                mesh_dim_names=MESH_DIMS)
        _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def make_host_mesh(model: int = 1, *, device="cpu"):
    """A mesh over every rank of the running process group:
    ``(world / model, model)`` (tests and examples)."""
    if not dist.is_initialized():
        raise ValueError("make_host_mesh needs a running process group")
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model extent {model} does not divide the world "
                         f"size {world}")
    return make_fed_mesh(world // model, model, device=device)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
