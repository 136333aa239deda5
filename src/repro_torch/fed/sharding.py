"""Fed-mode placement on the ``(agent, model)`` mesh (counterpart of
``repro/fed/sharding.py``, reduced to what sharded rounds run).

A sharded round runs one process per rank of an ``("agent", "model")``
:class:`torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`).  Where the reference gives GSPMD a
``PartitionSpec`` for each carrier, the port slices the carrier to this
rank's block by three rules:

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
* **Leaves** (the tree layout; the reference's ``param_specs``).  Each
  parameter's own axes take the reference's per-leaf rules
  (:data:`_RULES`, :func:`param_specs`): the tensor-parallel dim of a
  weight (heads, FFN hidden, vocab, scan channels; an expert leaf's
  leading ``E`` where the model extent divides it) goes on ``model``,
  the rest is replicated.  The port's mesh has no data axis, so the
  reference's FSDP slot is None.  A dim that the model extent does not
  divide stays replicated (``_sanitize``), and so does a leaf with no
  rule.  :class:`TreeBlocks` holds each leaf's split dim and cuts and
  gathers its block (:func:`tree_blocks`); the model ranks split each
  agent's batch rows as in the packed layout.

Collectives over the model group are ``all_reduce`` only, so that the
same code runs under NCCL and under gloo (whose CUDA tensors take
``all_reduce`` and ``broadcast`` only): :func:`model_gather` reduces a
zero-filled full buffer through its integer view (exact: each position
has one writer, and no float addition turns a ``-0.0`` into ``+0.0``),
and a sum that is kept in part is an ``all_reduce`` followed by
:func:`col_block`.

Every collective here goes through
:func:`repro_torch.collectives.all_reduce`, which tallies it for a
round's report.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import collectives

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


def col_block(t: torch.Tensor, mesh, width: Optional[int] = None,
              axis: int = -1):
    """This rank's columns (``axis``, the last by default) of a
    full-width tensor: a view, or ``t`` itself where the columns are not
    split."""
    width = t.shape[axis] if width is None else width
    if not cols_split(mesh, width):
        return t
    cols = model_cols(mesh, width)
    return t.narrow(axis, cols.start, cols.stop - cols.start)


def block_segments(segments, cols: slice):
    """The column ``segments`` of a packing that fall in ``cols``, cut to
    it and shifted to the block's own coordinates."""
    out = []
    for a, b in segments:
        a, b = max(a, cols.start), min(b, cols.stop)
        if a < b:
            out.append((a - cols.start, b - cols.start))
    return tuple(out)


def _exact_gather(block: torch.Tensor, shape, index, group,
                  site: str) -> torch.Tensor:
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
    collectives.all_reduce(flat.view(torch.int32), group, site)
    return full


def model_gather(block: torch.Tensor, mesh, width: int,
                 axis: int = -1) -> torch.Tensor:
    """The full tensor, ``width`` wide along ``axis`` (the last by
    default), of which this rank holds its column block, on every rank of
    the model group (:func:`_exact_gather`); ``block`` itself where the
    columns are not split."""
    if not cols_split(mesh, width):
        return block
    axis %= block.ndim
    shape = block.shape[:axis] + (width,) + block.shape[axis + 1:]
    index = (slice(None),) * axis + (model_cols(mesh, width),)
    return _exact_gather(block, shape, index, model_group(mesh),
                         "model_gather")


def agent_gather(block: torch.Tensor, mesh, n_agents: int) -> torch.Tensor:
    """The ``(n_agents, ...)`` rows of which this rank holds its row
    block, on every rank of the agent group (:func:`_exact_gather`);
    ``block`` itself on a 1-rank agent axis."""
    if mesh is None or mesh_agent_shards(mesh) == 1:
        return block
    return _exact_gather(block, (n_agents,) + tuple(block.shape[1:]),
                         agent_rows(mesh, n_agents), agent_group(mesh),
                         "agent_gather")


def gather_block(block: torch.Tensor, mesh, n_agents: int,
                 width: Optional[int] = None, rows: bool = True,
                 axis: int = -1) -> torch.Tensor:
    """The global tensor of which this rank holds ``block``: its columns
    (``axis``, the last by default) gathered over the model group when
    ``width`` is an extent that the mesh splits, then (``rows``) its agent
    rows over the agent group -- on every rank (a collective over both
    groups).  A leaf without an agent axis (``rows=False``, e.g. the dense
    coordinator row ``(n,)``) is gathered by columns only."""
    if not rows:
        if width is None:
            return block
        return model_gather(block[None], mesh, width)[0]
    if width is not None:
        block = model_gather(block, mesh, width, axis)
    return agent_gather(block, mesh, n_agents)


def own_block(full: torch.Tensor, mesh, n_agents: int,
              width: Optional[int] = None, rows: bool = True,
              axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`gather_block`: this rank's block of a global
    tensor (its agent rows when ``rows``, its columns of ``width`` along
    ``axis``).  Raises a ValueError where ``full`` has not ``n_agents``
    rows (``rows``) or not ``width`` columns: a global tensor of another
    run."""
    if (rows and full.shape[0] != n_agents) or (
            width is not None and full.shape[axis] != width):
        raise ValueError(
            f"shape mismatch: a global tensor of {tuple(full.shape)} is "
            f"not one of {n_agents if rows else 'no'} agent rows"
            + ("" if width is None else f" and {width} columns"))
    if rows:
        full = full[agent_rows(mesh, n_agents)]
    if width is not None:
        full = col_block(full, mesh, width, axis)
    return full


def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the model axis's ranks, in place (``t`` itself
    with a model extent of 1)."""
    if model_shards(mesh) > 1:
        collectives.all_reduce(t, model_group(mesh), "model_sum")
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
    collectives.all_reduce(t, agent_group(mesh), "agent_sum")
    return t


def agent_mean(row: torch.Tensor, mesh, n_agents: int) -> torch.Tensor:
    """The mean over all N agents of a per-agent row of which this rank
    holds its block: the local sum, all-reduced, over N (``torch.mean``
    itself without a mesh)."""
    if mesh is None:
        return torch.mean(row)
    return agent_sum(torch.sum(row), mesh) / n_agents


# ---------------------------------------------------------------------------
# Per-leaf specs of the tree layout (the reference's rules, verbatim)
# ---------------------------------------------------------------------------

# name fragments that identify the tensor-parallel dim of each weight:
# (leaf name, spec WITHOUT the stacked-unit axis), FSDP slot = 'F'
_RULES = [
    # embed: vocab on 'model' only (an FSDP d would shard the token gather)
    ("embed", ("model", None)),
    ("lm_head", ("F", "model")),
    ("wq", ("F", "model")),
    ("wk", ("F", "model")),
    ("wv", ("F", "model")),
    ("wo", ("model", "F")),
    ("wi", ("F", "model")),
    ("router", ("F", None)),
    ("in_proj", ("F", "model")),
    ("conv_w", (None, "model")),
    ("conv_b", ("model",)),
    ("x_proj", ("model", None)),
    ("dt_proj", (None, "model")),
    ("dt_bias", ("model",)),
    ("A_log", ("model", None)),
    ("D", ("model",)),
    ("out_proj", ("model", "F")),
    ("w_branch1", ("F", "model")),
    ("w_branch2", ("F", "model")),
    ("w_a", (None, "model")),
    ("w_x", (None, "model")),
    ("lam", ("model",)),
    ("w_out", ("model", "F")),
]
_EXPERT_PREFIX = "experts"      # adds a leading 'model' expert axis


def _axis_size(axis, axis_sizes):
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= axis_sizes.get(a, 1)
        return n
    return axis_sizes.get(axis, 1)


def _sanitize(base, shape, axis_sizes):
    """Drop axes whose size does not divide the dim (the reference's
    explicit in_shardings require exact divisibility)."""
    if axis_sizes is None:
        return base
    out = []
    for dim, axis in zip(shape, base):
        out.append(axis if dim % _axis_size(axis, axis_sizes) == 0
                   else None)
    return out


def _leaf_spec(name: str, shape, fsdp: Optional[str],
               axis_sizes: Optional[dict] = None) -> tuple:
    """The spec of one leaf (its dotted name, its shape without the agent
    axis): one axis name or None a dim."""
    names = name.split(".")
    leaf_name = names[-1]
    expert = _EXPERT_PREFIX in names
    base = None
    for frag, spec in _RULES:
        if leaf_name == frag:
            base = list(spec)
            break
    if base is None:
        base = []  # norms & misc: replicated
    base = [fsdp if a == "F" else a for a in base]
    ndim, shape = len(shape), tuple(shape)
    if expert and base:
        # expert-parallel: leading E axis takes 'model' when divisible;
        # otherwise keep plain TP on the inner dims
        e_dim = shape[max(0, ndim - len(base) - 1)]
        if axis_sizes is None or e_dim % _axis_size("model",
                                                    axis_sizes) == 0:
            base = [fsdp if a == "model" else a for a in base]
            base = ["model"] + base
    # pad leading axes (stacked units) with None
    while len(base) < ndim:
        base = [None] + base
    base = base[:max(ndim, 0)]
    return tuple(_sanitize(base, shape, axis_sizes))


def param_specs(shapes: dict, *, fsdp_axis: Optional[str] = "data",
                agent_axis: Optional[str] = None,
                axis_sizes: Optional[dict] = None) -> dict:
    """``{name: spec}`` for a model's ``{name: shape}`` (e.g.
    ``{n: s for n, (s, _) in model.param_shapes().items()}``), each spec a
    tuple of axis names or None.  ``agent_axis``: the leaves carry a
    leading stacked agent dimension sharded over that axis (fed mode; the
    shapes then include it).  ``axis_sizes``: dims not divisible by their
    assigned axis size fall back to replicated."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if agent_axis is not None:
            out[name] = (agent_axis,) + _leaf_spec(name, shape[1:],
                                                   fsdp_axis, axis_sizes)
        else:
            out[name] = _leaf_spec(name, shape, fsdp_axis, axis_sizes)
    return out


class TreeBlocks(NamedTuple):
    """The tree layout's placement under a model axis: ``dims[name]`` is
    the dim of leaf ``name`` (its shape without the agent axis) that the
    mesh's model axis splits, None where the leaf is replicated, and
    ``sizes[name]`` that dim's full extent.  ``lead`` counts the leading
    dims a tensor has before the leaf's own (1 for an agent-stacked
    leaf, 0 for a coordinator leaf)."""

    mesh: Any
    dims: dict
    sizes: dict

    def split(self, name: str) -> bool:
        return self.dims[name] is not None

    def block(self, name: str, t: torch.Tensor, lead: int = 1):
        """This rank's block of a full leaf (a view; ``t`` itself where
        the leaf is replicated)."""
        if not self.split(name):
            return t
        return col_block(t, self.mesh, self.sizes[name],
                         lead + self.dims[name])

    def gather(self, name: str, t: torch.Tensor, lead: int = 1):
        """The full leaf of which this rank holds ``t``, on every rank of
        the model group (``t`` itself where the leaf is replicated)."""
        if not self.split(name):
            return t
        return model_gather(t, self.mesh, self.sizes[name],
                            lead + self.dims[name])

    def block_tree(self, tree: dict, lead: int = 1) -> dict:
        return {n: self.block(n, l, lead) for n, l in tree.items()}

    def gather_tree(self, tree: dict, lead: int = 1) -> dict:
        return {n: self.gather(n, l, lead) for n, l in tree.items()}

    def cut(self, name: str, shape) -> Optional[tuple]:
        """``(full row shape, index)`` of leaf ``name``: how this rank's
        block sits in one agent's full row (``shape`` the leaf's shape
        without the agent axis); None where the leaf is replicated."""
        if not self.split(name):
            return None
        d = self.dims[name]
        full = tuple(shape[:d]) + (self.sizes[name],) + tuple(shape[d + 1:])
        return full, (slice(None),) * d + (
            model_cols(self.mesh, self.sizes[name]),)


def tree_blocks(shapes: dict, mesh) -> Optional[TreeBlocks]:
    """The tree layout's :class:`TreeBlocks` for a model's ``{name:
    shape}`` (without the agent axis) on ``mesh``; None without a model
    axis (no mesh, or a model extent of 1)."""
    m = model_shards(mesh)
    if m == 1:
        return None
    specs = param_specs(shapes, fsdp_axis=None,
                        axis_sizes={AGENT_AXIS: mesh_agent_shards(mesh),
                                    MODEL_AXIS: m})
    dims = {n: (s.index(MODEL_AXIS) if MODEL_AXIS in s else None)
            for n, s in specs.items()}
    sizes = {n: (shapes[n][d] if d is not None else None)
             for n, d in dims.items()}
    return TreeBlocks(mesh, dims, sizes)
