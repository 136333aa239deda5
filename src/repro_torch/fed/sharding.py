"""Fed-mode placement on the ``(agent, model)`` mesh (counterpart of
``repro/fed/sharding.py``, reduced to what sharded rounds run).

A sharded round runs one process per rank of an ``("agent", "model")``
:class:`torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`).  Where the reference gives GSPMD a
``PartitionSpec`` for each carrier, the port slices the carrier to this
rank's block by two rules:

* **Rows.**  With ``s`` agent shards, the rank at agent coordinate ``r``
  owns agents ``[r N / s, (r + 1) N / s)`` of every per-agent carrier --
  the state rows, the batch, and every ``(N,)`` round row
  (participation, corruption, live): :func:`agent_rows`,
  :func:`fed_batch_specs`, :func:`fed_row_spec`.
* **Columns** (the reference's ``fed_state_specs(packed=True)`` and
  ``engine._mesh_col_axis``).  With model extent ``m > 1`` dividing the
  packed width ``W``, the rank at model coordinate ``c`` owns columns
  ``[c W / m, (c + 1) W / m)`` of every ``(N, W)`` state buffer
  (:func:`model_cols`, :func:`col_block`); otherwise the columns are
  replicated within the agent shard.  The model ranks of one agent shard
  also split each agent's batch rows (:func:`batch_share`): each runs
  the forward on its share, so the model axis divides both the state
  and the per-agent compute, as GSPMD divides the reference's forward.

Collectives over the model group are ``all_reduce`` only, so that the
same code runs under NCCL and under gloo (whose CUDA tensors take
``all_reduce`` and ``broadcast`` only): :func:`model_gather` reduces a
zero-filled full buffer through its integer view (exact: each position
has one writer, and no float addition turns a ``-0.0`` into ``+0.0``),
and a sum that is kept in part is an ``all_reduce`` followed by
:func:`col_block`.

Not ported: the per-leaf ``_RULES`` / ``param_specs`` of the tree
layout, which shard each parameter's own axes (the only way the SSM and
RG-LRU kinds, whose mixed-dtype trees take the tree layout, could use
the model axis).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

AGENT_AXIS = "agent"
MODEL_AXIS = "model"


def fed_axes(axis_sizes) -> tuple:
    """``(agent_axis, fsdp_axis)`` of a mesh for fed mode, the
    reference's one axis-picking rule: a dedicated ``agent`` axis wins,
    then a multi-pod ``pod`` axis, else the agent stack rides ``data``
    and FSDP is off.  The port's meshes are ``(agent, model)``, so it
    gives ``("agent", None)`` for them."""
    if "agent" in axis_sizes:
        return "agent", "data" if "data" in axis_sizes else None
    if "pod" in axis_sizes:
        return "pod", "data" if "data" in axis_sizes else None
    if "data" in axis_sizes:
        return "data", None
    return None, None


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


def model_shards(mesh) -> int:
    """The extent of ``mesh``'s model axis (1 when ``mesh`` is None or
    has no model axis)."""
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names or ())
    if MODEL_AXIS not in names:
        return 1
    return int(mesh.shape[names.index(MODEL_AXIS)])


def model_group(mesh) -> dist.ProcessGroup:
    """The process group of this rank's model axis (the ranks that hold
    the column blocks of one agent shard)."""
    return mesh.get_group(MODEL_AXIS)


def block_rows(n: int, shards: int, r: int) -> slice:
    """Rows ``[r n / shards, (r + 1) n / shards)``: coordinate ``r``'s
    block of an axis of ``n`` split evenly over ``shards``."""
    rows = n // shards
    return slice(r * rows, (r + 1) * rows)


def block_cols(width: int, m: int, c: int) -> slice:
    """The column rule: coordinate ``c``'s block of ``width`` columns
    over a model extent ``m`` -- ``[c W / m, (c + 1) W / m)`` when
    ``m > 1`` divides ``W``, else every column (replicated)."""
    if m > 1 and width % m == 0:
        return block_rows(width, m, c)
    return slice(0, width)


def agent_rows(mesh, n_agents: int) -> slice:
    """This rank's contiguous block of the agent axis."""
    return block_rows(n_agents, mesh_agent_shards(mesh),
                      mesh.get_local_rank(AGENT_AXIS))


def cols_split(mesh, width: int) -> bool:
    """Whether ``mesh`` splits ``width`` packed columns over its model
    axis (the reference's ``_mesh_col_axis`` is not None)."""
    m = model_shards(mesh)
    return m > 1 and width % m == 0


def model_cols(mesh, width: int) -> slice:
    """This rank's columns of a packed width (all of them without a
    mesh, or where the columns are replicated)."""
    m = model_shards(mesh)
    if m == 1:
        return slice(0, width)
    return block_cols(width, m, mesh.get_local_rank(MODEL_AXIS))


def col_block(t: torch.Tensor, mesh, width: Optional[int] = None):
    """This rank's columns (last axis) of a full-width tensor: a view,
    or ``t`` itself where the columns are not split."""
    width = t.shape[-1] if width is None else width
    if not cols_split(mesh, width):
        return t
    return t[..., model_cols(mesh, width)]


def block_segments(segments, cols: slice):
    """The column ``segments`` of a packing that fall in ``cols``, cut to
    it and shifted to the block's own coordinates."""
    out = []
    for a, b in segments:
        a, b = max(a, cols.start), min(b, cols.stop)
        if a < b:
            out.append((a - cols.start, b - cols.start))
    return tuple(out)


def _exact_gather(block: torch.Tensor, shape, index, group) -> torch.Tensor:
    """A zero-filled ``shape`` buffer with ``block`` written at ``index``,
    all-reduced over ``group`` through its int32 view: every position has
    one writer, so the bits arrive exactly (a float sum would turn a
    ``-0.0`` into ``+0.0``)."""
    n = math.prod(shape)
    # an even count of 16-bit elements, so the buffer has an int32 view
    pad = n % 2 if block.element_size() == 2 else 0
    flat = torch.zeros(n + pad, dtype=block.dtype, device=block.device)
    full = flat[:n].view(shape)
    full[index] = block
    dist.all_reduce(flat.view(torch.int32), group=group)
    return full


def model_gather(block: torch.Tensor, mesh, width: int) -> torch.Tensor:
    """The full ``(rows, width)`` rows of which this rank holds its
    column block, on every rank of the model group (:func:`_exact_gather`);
    ``block`` itself where the columns are not split."""
    if not cols_split(mesh, width):
        return block
    return _exact_gather(block, (block.shape[0], width),
                         (slice(None), model_cols(mesh, width)),
                         model_group(mesh))


def agent_gather(block: torch.Tensor, mesh, n_agents: int) -> torch.Tensor:
    """The ``(n_agents, ...)`` rows of which this rank holds its row
    block, on every rank of the agent group (:func:`_exact_gather`);
    ``block`` itself on a 1-rank agent axis."""
    if mesh is None or mesh_agent_shards(mesh) == 1:
        return block
    return _exact_gather(block, (n_agents,) + tuple(block.shape[1:]),
                         agent_rows(mesh, n_agents), agent_group(mesh))


def gather_block(block: torch.Tensor, mesh, n_agents: int,
                 width: Optional[int] = None,
                 rows: bool = True) -> torch.Tensor:
    """The global tensor of which this rank holds ``block``: its columns
    gathered over the model group when ``width`` is a packed width that
    the mesh splits, then (``rows``) its agent rows over the agent group
    -- on every rank (a collective over both groups).  A leaf without an
    agent axis (``rows=False``, e.g. the dense coordinator row ``(n,)``)
    is gathered by columns only."""
    if not rows:
        if width is None:
            return block
        return model_gather(block[None], mesh, width)[0]
    if width is not None:
        block = model_gather(block, mesh, width)
    return agent_gather(block, mesh, n_agents)


def own_block(full: torch.Tensor, mesh, n_agents: int,
              width: Optional[int] = None,
              rows: bool = True) -> torch.Tensor:
    """Inverse of :func:`gather_block`: this rank's block of a global
    tensor (its agent rows when ``rows``, its columns of ``width``).
    Raises a ValueError where ``full`` has not ``n_agents`` rows
    (``rows``) or not ``width`` columns: a global tensor of another run."""
    if (rows and full.shape[0] != n_agents) or (
            width is not None and full.shape[-1] != width):
        raise ValueError(
            f"shape mismatch: a global tensor of {tuple(full.shape)} is "
            f"not one of {n_agents if rows else 'no'} agent rows"
            + ("" if width is None else f" and {width} columns"))
    if rows:
        full = full[agent_rows(mesh, n_agents)]
    if width is not None:
        full = col_block(full, mesh, width)
    return full


def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the model axis's ranks, in place (``t`` itself
    with a model extent of 1)."""
    if model_shards(mesh) > 1:
        dist.all_reduce(t, group=model_group(mesh))
    return t


def batch_share(mesh, b: int) -> slice:
    """This rank's contiguous share of an agent's ``b`` batch rows: the
    model ranks of an agent shard split them as evenly as they go (the
    first ``b mod m`` ranks take one more; a share may be empty)."""
    m = model_shards(mesh)
    if m == 1:
        return slice(0, b)
    c = mesh.get_local_rank(MODEL_AXIS)
    q, r = divmod(b, m)
    start = c * q + min(c, r)
    return slice(start, start + q + (c < r))


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
