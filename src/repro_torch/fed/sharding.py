"""Fed-mode placement on the agent axis (counterpart of
``repro/fed/sharding.py``, reduced to what sharded rounds run).

A sharded round runs one process per rank of an ``("agent", "model")``
:class:`torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`).  The one row-block rule: with ``s``
agent shards, the rank at agent coordinate ``r`` owns agents
``[r N / s, (r + 1) N / s)`` of every per-agent carrier -- the state
rows, the batch, and every ``(N,)`` round row (participation, corruption,
live).  Where the reference gives GSPMD a ``PartitionSpec`` for each
carrier, the port slices the carrier to this rank's block:
:func:`fed_batch_specs` slices an agent-stacked batch and
:func:`fed_row_spec` an ``(N, ...)`` round row.

Not ported yet: the tensor-parallel ``model`` axis (the per-leaf
``_RULES`` / ``param_specs`` that shard each parameter, and ``fed_axes``,
which picks the agent axis among ``agent`` / ``pod`` / ``data`` for
them), which waits for a mesh whose model extent exceeds 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AGENT_AXIS = "agent"


def mesh_agent_shards(mesh) -> int:
    """The extent of ``mesh``'s agent axis (1 when ``mesh`` is None)."""
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names or ())
    if AGENT_AXIS not in names:
        raise ValueError(
            f"sharded rounds need a mesh with an 'agent' axis, got "
            f"axes {names}")
    return int(mesh.shape[names.index(AGENT_AXIS)])


def agent_group(mesh) -> dist.ProcessGroup:
    """The process group of this rank's agent axis (the ranks that hold
    one row block each)."""
    return mesh.get_group(AGENT_AXIS)


def agent_rows(mesh, n_agents: int) -> slice:
    """This rank's contiguous block of the agent axis."""
    shards = mesh_agent_shards(mesh)
    rows = n_agents // shards
    r = mesh.get_local_rank(AGENT_AXIS)
    return slice(r * rows, (r + 1) * rows)


def fed_row_spec(row, mesh, n_agents: int):
    """This rank's block of a per-agent round row (``(N,)`` or
    ``(N, k)``); None stays None."""
    if row is None or mesh is None:
        return row
    row = torch.as_tensor(row)
    if row.shape[0] != n_agents:
        raise ValueError(f"round row has {row.shape[0]} entries for "
                         f"n_agents={n_agents}")
    return row[agent_rows(mesh, n_agents)]


def fed_batch_specs(batch: dict, mesh, n_agents: int) -> dict:
    """This rank's agents of an agent-stacked batch ``(N, b, ...)``."""
    if mesh is None:
        return batch
    rows = agent_rows(mesh, n_agents)
    out = {}
    for k, v in batch.items():
        if v.shape[0] != n_agents:
            raise ValueError(f"batch leaf {k!r} has {v.shape[0]} agents, "
                             f"want n_agents={n_agents}")
        out[k] = v[rows]
    return out


def agent_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the agent axis's ranks, in place."""
    dist.all_reduce(t, group=agent_group(mesh))
    return t


def agent_mean(row: torch.Tensor, mesh, n_agents: int) -> torch.Tensor:
    """The mean over all N agents of a per-agent row of which this rank
    holds its block: the local sum, all-reduced, over N (``torch.mean``
    itself without a mesh)."""
    if mesh is None:
        return torch.mean(row)
    return agent_sum(torch.sum(row), mesh) / n_agents
