"""The Fed-PLT round engine, synchronous core (counterpart of
``repro/fed/engine.py``).

Every leaf of the state carries a leading agent axis ``(N, ...)``.  One
round:

  coordinator:  y = prox_{rho h / N}( mean_i z_i )            (Lemma 6)
  agents i active (u_i ~ Ber(p_i)):
      v_i   = 2 y - z_i                                       (reflection)
      x_i   <- N_e epochs of the local solver on
               d_i(w) = f_i(w) + ||w - v_i||^2/(2 rho),  warm start x_i
      z_i   <- z_i + 2 * damping * (x_i - y)
  agents inactive: state unchanged.

Round-edge backends (``RoundConfig.engine_backend``): ``"torch"`` runs
the edges as unfused tensor ops (the reference's ``"xla"``); ``"fused"``
runs them as the two :mod:`repro_torch.kernels.round_edge` launches on
the packed ``(N, M)`` buffer (the reference's ``"pallas"``).  A prox
without the ``elementwise`` tag takes the torch edge under either
backend, as :func:`fusible_prox` decides -- the reference's semantics.

State layouts (``RoundConfig.state_layout``): ``"tree"`` carries
agent-stacked trees; ``"packed"`` one resident ``(N, width)`` buffer per
state variable (:func:`packed_round_step`), unpacked only at the API
boundary and, as views, inside the gradient oracle.

Compressed z-exchange (``RoundConfig.compression`` != ``"none"``): the
coordinator sees its lagged copy ``t`` of the agents' ``z`` (the uplink
and the downlink read ``t`` where they read ``z`` when exact); after the
downlink each agent transmits ``q = compress(z_new - t)`` and
``t <- t + u q``, so the never-transmitted residual is the error-feedback
memory.  ``t`` is advanced IN PLACE (``addcmul_``): for ``u`` in {0, 1}
the product ``u q`` is exact, so one rounding of ``t + u q`` gives the
reference's bits, and no second ``t``-sized buffer is made.  The round
therefore consumes the ``t`` it is given.

Randomness: the participation row is drawn from a ``torch.Generator``
(the reference uses JAX's threefry; the bits differ), or given
explicitly as an ``(N,)`` row, which is how the parity tests replay the
reference's draws.

Faults and robustness (the reference's fault hooks, in its order): the
coordinator's input passes :func:`robust_seen` (a robust aggregate of the
live rows broadcast back, or the survivor-mean rescale for ``mean``);
after the local solvers :func:`apply_corruption` injects a recorded
corruption row; evicted agents leave the participation row
(:func:`live_mask_rows`); :func:`increment_guard` turns a non-finite or
over-norm row into a non-arrival.  With ``corrupt=None``, ``live=None``,
guards off and ``mean`` each of them returns its input unchanged, so the
round is the fault-free one bit for bit (``z_seen is z`` still selects
the exact edges).

SHARDED ROUNDS -- the MESH CONTRACT (the reference's, on
``torch.distributed``): passing ``mesh`` (an ``("agent", "model")``
:class:`torch.distributed.device_mesh.DeviceMesh`, one process per rank;
:mod:`repro_torch.launch.mesh`) to :func:`round_step` /
:func:`packed_round_step` runs the round on this rank's contiguous
``n_agents / agent_shards`` row block of every per-agent carrier
(:mod:`repro_torch.fed.sharding`): the state the caller passes is that
block, and the ``(N,)`` rows it passes (``u``, ``corrupt``, ``live``) are
GLOBAL -- the engine slices them, and keeps the global ``live`` where the
coordinator needs it.  The uplink's agent mean becomes a local column sum
(one ``round_uplink_partial`` launch under the fused backend), ONE
``(1, width)`` all-reduce over the mesh's ``agent`` group, then
``/ N -> prox -> reflection`` at coordinator size; the downlink consumes
the replicated ``y`` with row-local work (one ``round_downlink_presummed``
launch), so a fused sharded round launches two edge kernels per rank.
Everything between the edges (solvers, compression, fault hooks, guards)
is row-wise.  A 1-rank mesh equals the unsharded engine bit for bit in
float32 (the fused uplink multiplies by the float32 reciprocal ``1/N``
after the all-reduce, as the unsharded kernel does; the torch backend
divides the sum by N, as ``torch.mean`` does); in bf16 the partial sum
is rounded to bf16 before the division, as in the reference.  Several
ranks agree with one to float32 rounding (the all-reduce reorders the
sum).  A non-elementwise prox under a mesh all-reduces the sums, applies
the prox to the whole coordinator tree on every rank, and reflects
locally.  An order-statistic aggregator gathers the row blocks first
(:func:`repro_torch.fed.robust.robust_seen_packed`); the survivor mean
scales by the global ``N / n_live``.

The ``model`` axis, packed layout (the reference's ``_mesh_col_axis``):
with model extent ``m > 1`` dividing the packed width, each rank holds
the ``(N / agent_shards, width / m)`` column block of every state buffer
(:func:`repro_torch.fed.sharding.model_cols`; otherwise the columns are
replicated).  Every edge is per-column arithmetic, so the uplink's
partial sum, its all-reduce over the AGENT group only, ``/ N -> prox ->
reflection`` and the downlink run unchanged on the block: on the same
inputs a ``1 x m`` mesh gives the ``1 x 1`` mesh's ``y``, ``x`` and
``z`` columns bit for bit.  What couples columns reaches over the model
group: the guard's row norms and ``norm_clip_mean``'s residual norms sum
their partials, the compressor gathers the rows (its segments are leaves
of the global layout), and a non-elementwise prox gathers the ``(1,
width)`` coordinator row, applies the prox to the tree, and keeps the
block (the reference's fall-through to the unsharded formula).

The ``model`` axis, tree layout (the reference's per-leaf
``param_specs``): :func:`round_step` takes ``blocks``
(:class:`repro_torch.fed.sharding.TreeBlocks`), and each rank holds each
leaf's block by its spec -- the leaf's tensor-parallel dim split over
the model ranks, a leaf with no rule or whose dim the extent does not
divide replicated -- in the leaf's own dtype.  The edges run unchanged
on the blocks, per leaf (or packed, where the leaves share a dtype).
What couples a leaf's entries reaches over the model group: the guard's
row norms sum the split leaves' partials (a replicated leaf counts
once), the compressor gathers each leaf's rows (its keep-counts and
scales are per leaf), an order-statistic or ``norm_clip_mean``
aggregate gathers the leaves, and a non-elementwise prox gathers each
coordinator leaf.  The gradient oracle's model-axis work, in both
layouts, is :mod:`repro_torch.fed.runtime`'s.

Bounded-staleness async rounds (``RoundConfig.staleness``, mode
``"stale"``) run in :mod:`repro_torch.fed.async_engine` on these edges.

Heterogeneous agent groups (a tuple of :class:`SolverGroup`): contiguous
row slices of the agent axis, each solved by its own solver on its rows
(:func:`run_solvers`), the groups in order, each writing its rows of one
output buffer.  A per-agent participation tuple gives each group's agents
their rate.  Under a mesh a group boundary must be a shard boundary
(:func:`validate_mesh`), and each rank runs the groups that own its rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from repro_torch.fed import compress as compress_lib
from repro_torch.fed import robust as robust_lib
from repro_torch.fed import sharding
from repro_torch.fed.sharding import mesh_agent_shards
from repro_torch.fed.solvers import LocalSolver
from repro_torch.kernels.robust_agg.ref import live_row
from repro_torch.kernels.round_edge import ops as edge_ops

tree_map = pytree.tree_map

ENGINE_BACKENDS = ("torch", "fused")
ENGINE_LAYOUTS = ("tree", "packed")

# round synchrony modes: "off" = the bulk-synchronous round; "stale" = the
# bounded-staleness async model (an arrival mask and per-agent staleness
# counters: repro_torch.fed.async_engine)
ASYNC_MODES = ("off", "stale")

# Leaf-wise proximal operator of the coordinator regularizer h (None =
# h = 0), applied with rho_eff = rho / N (Lemma 6).
ProxH = Optional[Callable[[Any, float], Any]]


def _numeric_scalar(name: str, value) -> float:
    if isinstance(value, (str, bytes)):
        raise ValueError(f"{name} must be a number, got the string {value!r}")
    try:
        return float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a number, got {value!r}") from None


def _int_scalar(name: str, value) -> int:
    """An integer knob: ints (and integral floats) pass, anything else
    raises."""
    if isinstance(value, (str, bytes, bool)):
        raise ValueError(f"{name} must be an integer, got {value!r}")
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be an integer, got {value!r}") from None
    if f != int(f):
        raise ValueError(f"{name} must be an integer, got {value!r}")
    return int(f)


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """Bounded-staleness async-round knobs (the reference's).

    ``mode="stale"`` turns the participation draw into an ARRIVAL draw:
    arriving agents submit their increment (tagged with the coordinator
    point it was computed against) and pull a fresh reflection next
    round; the others keep training against their stale reflection and
    age a per-agent counter.  ``max_staleness`` is the bound K: an agent
    holding work K rounds old is forced to arrive.  K = 0 allows no stale
    work -- a miss discards the round's local work -- which is the
    synchronous round bit for bit (:mod:`repro_torch.fed.async_engine`)."""

    mode: str = "off"            # "off" | "stale"
    max_staleness: int = 0       # K: forced arrival at staleness K

    def __post_init__(self):
        if self.mode not in ASYNC_MODES:
            raise ValueError(
                f"unknown async mode {self.mode!r}; "
                f"known: {', '.join(ASYNC_MODES)}")
        k = _int_scalar("max_staleness", self.max_staleness)
        if k < 0:
            raise ValueError(f"max_staleness must be >= 0, got {k}")
        object.__setattr__(self, "max_staleness", k)

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


class SolverGroup(NamedTuple):
    """A contiguous slice of the agent axis (``size`` rows, after the
    groups before it) with its own solver."""

    size: int
    solver: LocalSolver


SolverAssignment = Union[LocalSolver, Tuple[SolverGroup, ...]]


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    """Round-topology knobs (the reference's ``RoundConfig``)."""

    n_agents: int
    rho: float = 1.0
    # one scalar p, or an (n_agents,)-tuple of per-agent probabilities
    participation: Union[float, Tuple[float, ...]] = 1.0
    damping: float = 1.0
    # compressor name in the repro_torch.fed.compress registry
    compression: str = "none"
    compress_ratio: float = 0.25      # top-k fraction kept (floor for adaptive)
    compress_energy: float = 0.95     # adaptive_topk per-agent energy target
    # "torch" = per-leaf registry compressors; "fused" = the
    # repro_torch.kernels.compress kernels on the packed buffer, one launch
    # per round; "auto" = the kernel wherever one exists
    compress_backend: str = "torch"
    engine_backend: str = "torch"
    state_layout: str = "tree"
    # bounded-staleness async rounds: "off" keeps the synchronous round;
    # "stale" makes the participation draw an arrival mask with per-agent
    # staleness counters (front ends dispatch to async_engine)
    staleness: StalenessConfig = dataclasses.field(
        default_factory=StalenessConfig)
    # in-round increment guards: a non-finite row of the local solvers'
    # output, or one whose l2 norm exceeds guard_norm_bound, becomes a
    # non-arrival (u_i -> 0).  Clean rows multiply u by ones: unchanged
    guard_increments: bool = False
    guard_norm_bound: float = float("inf")   # inf = finiteness-only screen
    # coordinator aggregator (repro_torch.fed.robust registry): "mean"
    # keeps the fault-free uplink; "trimmed_mean" (param = trim count f),
    # "coord_median" and "norm_clip_mean" (param = clip radius) replace
    # the agent mean with a robust statistic of the live rows
    aggregator: str = "mean"
    aggregator_param: float = 0.0
    # number of contiguous row blocks the agent axis is sharded into
    # when a mesh is passed to the round step (mesh contract in the
    # module docstring); 1 = unsharded.  Every shard owns
    # n_agents/agent_shards agents, so N must divide evenly
    agent_shards: int = 1

    def __post_init__(self):
        compress_lib.get_compressor(self.compression)
        object.__setattr__(
            self, "aggregator_param",
            robust_lib.validate_aggregator(
                self.aggregator, self.aggregator_param, self.n_agents))
        if self.compress_backend not in compress_lib.COMPRESS_BACKENDS:
            raise ValueError(
                f"unknown compress backend {self.compress_backend!r}; "
                f"known: {', '.join(compress_lib.COMPRESS_BACKENDS)}")
        if self.engine_backend not in ENGINE_BACKENDS:
            raise ValueError(
                f"unknown engine backend {self.engine_backend!r}; "
                f"known: {', '.join(ENGINE_BACKENDS)}")
        if self.state_layout not in ENGINE_LAYOUTS:
            raise ValueError(
                f"unknown state layout {self.state_layout!r}; "
                f"known: {', '.join(ENGINE_LAYOUTS)}")
        object.__setattr__(self, "damping",
                           _numeric_scalar("damping", self.damping))
        object.__setattr__(self, "rho", _numeric_scalar("rho", self.rho))
        shards = _int_scalar("agent_shards", self.agent_shards)
        if shards < 1:
            raise ValueError(f"agent_shards must be >= 1, got {shards}")
        object.__setattr__(self, "agent_shards", shards)
        if self.n_agents % shards:
            raise ValueError(
                f"n_agents={self.n_agents} is not divisible by "
                f"agent_shards={shards}: every shard owns an equal "
                f"contiguous row block of the agent axis -- choose "
                f"n_agents a multiple of the shard count (or reduce "
                f"agent_shards)")
        object.__setattr__(self, "guard_increments",
                           bool(self.guard_increments))
        bound = _numeric_scalar("guard_norm_bound", self.guard_norm_bound)
        if not bound > 0.0:   # rejects 0, negatives, and NaN
            raise ValueError(
                f"guard_norm_bound must be > 0 (inf disables the norm "
                f"screen), got {bound}")
        object.__setattr__(self, "guard_norm_bound", bound)
        if self.staleness is None:
            object.__setattr__(self, "staleness", StalenessConfig())
        elif not isinstance(self.staleness, StalenessConfig):
            raise ValueError(f"staleness must be a StalenessConfig, got "
                             f"{self.staleness!r}")
        p = self.participation
        if isinstance(p, (str, bytes)):
            raise ValueError(
                f"participation must be a probability or a per-agent "
                f"sequence of probabilities, got the string {p!r}")
        if isinstance(p, (list, tuple)):
            p = tuple(float(x) for x in p)
            if len(p) != self.n_agents:
                raise ValueError(
                    f"per-agent participation has {len(p)} entries for "
                    f"n_agents={self.n_agents}")
        else:
            p = float(p)
        object.__setattr__(self, "participation", p)

    @property
    def compressed(self) -> bool:
        return self.compression != "none"

    @property
    def fused(self) -> bool:
        return self.engine_backend == "fused"

    @property
    def robust_aggregator(self) -> Optional[str]:
        """The aggregator name when the uplink is actually robust, else
        None: ``"mean"`` -- and ``"trimmed_mean"`` at ``f = 0``, which IS
        the mean -- keep the survivor-mean path, so clean configurations
        run the fault-free round bit for bit."""
        if self.aggregator == "mean":
            return None
        if (self.aggregator == "trimmed_mean"
                and int(self.aggregator_param) == 0):
            return None
        return self.aggregator


class RoundResult(NamedTuple):
    x: Any               # tree, leaves (N, ...) -- or (N, width) buffer
    z: Any
    t: Any               # coordinator's copy of z (z_new when uncompressed)
    y: Any               # coordinator model (no agent axis / (1, width))
    u: torch.Tensor      # (N,) float32 participation row of this round
    aux: Any             # whatever the local solver returned


# ---------------------------------------------------------------------------
# Round pieces
# ---------------------------------------------------------------------------

def agent_mean(z: Any) -> Any:
    """Mean over the leading agent axis, leaf-wise."""
    return tree_map(lambda zl: torch.mean(zl, dim=0), z)


def coordinator_prox(z: Any, cfg: RoundConfig, prox_h: ProxH = None) -> Any:
    """``y = prox_{rho h / N}(mean_i z_i)`` on trees (Lemma 6)."""
    zbar = agent_mean(z)
    if prox_h is None:
        return zbar
    rho_eff = cfg.rho / cfg.n_agents
    return tree_map(lambda zl: prox_h(zl, rho_eff), zbar)


def reflect(y: Any, z: Any) -> Any:
    """``v = 2 y - z`` with y broadcast across the agent axis."""
    return tree_map(lambda yl, zl: 2.0 * yl[None] - zl, y, z)


def participation_mask(cfg: RoundConfig, device, generator=None,
                       u=None) -> torch.Tensor:
    """One Bernoulli(p_i) draw per agent as a float32 ``(N,)`` row, or
    the given row ``u`` (a replayed draw), checked and converted."""
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32).to(device).reshape(-1)
        if u.numel() != cfg.n_agents:
            raise ValueError(f"participation row has {u.numel()} entries "
                             f"for n_agents={cfg.n_agents}")
        return u
    p = cfg.participation
    if isinstance(p, tuple):
        p = torch.tensor(p, dtype=torch.float32).to(device)
    # a scalar p is compared as a number: no host-to-device copy, which
    # would wait for the device every round
    draw = torch.rand((cfg.n_agents,), generator=generator, device=device)
    return (draw < p).float()


def masked_mix(u: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` where the agent participated, ``old`` otherwise --
    ``torch.where``, so a NaN local solve cannot leak into agents that
    sat the round out."""
    mask = u != 0

    def mix(nl, ol):
        return torch.where(mask.reshape((-1,) + (1,) * (nl.ndim - 1)),
                           nl, ol)

    return tree_map(mix, new, old)


# ---------------------------------------------------------------------------
# Faults: corruption injection, increment guards, survivor means and the
# robust aggregate.  Each returns its input unchanged when disabled
# (corrupt=None / guards off / live=None / mean).
# ---------------------------------------------------------------------------

def apply_corruption(w: Any, corrupt) -> Any:
    """Inject a recorded corruption row into the local solvers' output.

    ``corrupt`` is an ``(N,)`` row -- agent ``i``'s rows become
    ``w * corrupt[i]`` wherever the entry is non-zero or NaN (NaN poisons
    the row, a huge value trips the norm guard) -- or an ``(N, 2)``
    ``[mult, add]`` pair per agent: rows whose pair is not ``(0, 0)``
    become ``w * mult + add`` (``sign_flip`` = ``(-1, 0)``, ``scale(v)``
    = ``(v, 0)``, ``drift(v)`` = ``(1, v)``).  ``mult`` and ``add`` are
    rounded to the leaf's dtype first, as the reference casts them.
    ``None`` returns ``w`` unchanged.

    The flagged rows are rewritten IN PLACE (the round owns its solvers'
    output, a fresh buffer): at full width a functional form would hold
    one more state-sized buffer.  The row is read on the host."""
    if corrupt is None:
        return w
    c = torch.as_tensor(corrupt, dtype=torch.float32).cpu()
    pairs = c if c.ndim == 2 else torch.stack([c.reshape(-1),
                                               torch.zeros(c.numel())], 1)
    # NaN != 0 is True: NaN entries flag the row (poison)
    flagged = ((pairs[:, 0] != 0.0) | (pairs[:, 1] != 0.0)).tolist()
    for leaf in pytree.tree_leaves(w):
        # the pairs rounded to the leaf's dtype, as Python floats
        rows = pairs.to(leaf.dtype).tolist()
        for i, (mult, add) in enumerate(rows):
            if flagged[i]:
                leaf[i].mul_(mult)
                if c.ndim == 2:
                    leaf[i].add_(add)
    return w


def _row_sq_norms(w: Any, meta=None, mesh=None,
                  blocks=None) -> torch.Tensor:
    """Per-agent squared l2 norm over the non-agent axes, in float32.
    For a resident packed buffer pass ``meta``: only the real columns
    count (padding may have drifted, even to NaN).  Under a ``mesh``
    whose model axis splits the columns, ``w`` is this rank's column
    block: the partial squares are summed over the model group, so the
    norm is over the whole row.  A tree of leaf ``blocks`` sums its split
    leaves' partials over the model group and adds the replicated leaves
    once."""
    if meta is not None:
        if mesh is None:
            return robust_lib.row_sq_norms(w, meta.segments)
        segs = sharding.block_segments(
            meta.segments, sharding.model_cols(mesh, meta.width))
        sq = robust_lib.row_sq_norms(w, segs)
        if sharding.cols_split(mesh, meta.width):
            sharding.model_sum(sq, mesh)
        return sq
    if blocks is not None:
        part = rest = None
        for name, l in w.items():
            sq = robust_lib.row_sq_norms(l.reshape(l.shape[0], -1))
            if blocks.split(name):
                part = sq if part is None else part + sq
            else:
                rest = sq if rest is None else rest + sq
        if part is not None:
            part = sharding.model_sum(part, blocks.mesh)
        return part if rest is None else (rest if part is None
                                          else rest + part)
    total = None
    for l in pytree.tree_leaves(w):
        sq = robust_lib.row_sq_norms(l.reshape(l.shape[0], -1))
        total = sq if total is None else total + sq
    return total


def increment_guard(cfg: RoundConfig, w: Any, u: torch.Tensor, meta=None,
                    mesh=None, blocks=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The uplink screen: returns ``(u_guarded, ok)``, ``ok`` the
    per-agent ``(N,)`` bool clean mask (None when guards are off).  A
    row that is non-finite, or whose l2 norm exceeds
    ``cfg.guard_norm_bound``, becomes a non-arrival (``u_i -> 0``), and
    the NaN-safe selects downstream keep it out of ``(x, z, t)``.  With
    every row clean ``u * ok`` multiplies by ones.  ``mesh``, ``blocks``:
    see :func:`_row_sq_norms`."""
    if not cfg.guard_increments:
        return u, None
    sq = _row_sq_norms(w, meta, mesh, blocks)
    ok = torch.isfinite(sq)
    if math.isfinite(cfg.guard_norm_bound):
        bound = torch.tensor(cfg.guard_norm_bound, dtype=torch.float32)
        ok = ok & (sq <= (bound ** 2).to(sq.device))
    return u * ok.to(u.dtype), ok


def survivor_mean_input(cfg: RoundConfig, z_seen: Any, live,
                        mesh=None) -> Any:
    """Fold an eviction ``live`` row into the coordinator's input so the
    edges' mean over N becomes the mean over survivors: ``z * live *
    (N / n_live)``.  ``live=None`` returns ``z_seen`` itself.  Under a
    ``mesh`` ``z_seen`` is this rank's row block and ``live`` the global
    row: the scale uses the global N and count of live agents."""
    if live is None:
        return z_seen
    device = pytree.tree_leaves(z_seen)[0].device
    lv = live_row(live, cfg.n_agents, device)
    # a true division (a Python number over a tensor would multiply by
    # the tensor's reciprocal)
    scale = lv * (lv.new_tensor(float(cfg.n_agents)) / lv.sum())
    scale = sharding.fed_row_spec(scale, mesh, cfg.n_agents)
    return tree_map(
        lambda l: l * scale.to(l.dtype).reshape((-1,) + (1,) * (l.ndim - 1)),
        z_seen)


def robust_seen(cfg: RoundConfig, z_seen: Any, live, meta=None,
                mesh=None, blocks=None) -> Any:
    """The uplink's aggregation input transform.  ``mean`` (and
    ``trimmed_mean`` at ``f = 0``) is :func:`survivor_mean_input`, which
    returns ``z_seen`` itself without a live row, so the exact edges are
    still selected by ``z_seen is z``.  A robust aggregator computes its
    ``(1, M)`` statistic over the live rows and broadcasts it back across
    the agent axis (:mod:`repro_torch.fed.robust`).  ``meta`` marks the
    packed form (``z_seen`` a resident ``(N, width)`` buffer).  Under a
    ``mesh`` ``z_seen`` is this rank's row block and ``live`` the global
    row (the robust aggregate all-gathers the blocks; a tree of leaf
    ``blocks`` is gathered over the model group too)."""
    name = cfg.robust_aggregator
    if name is None:
        return survivor_mean_input(cfg, z_seen, live, mesh)
    if meta is not None:
        return robust_lib.robust_seen_packed(
            z_seen, live, name=name, param=cfg.aggregator_param, meta=meta,
            backend=cfg.engine_backend, mesh=mesh)
    return robust_lib.robust_seen_tree(
        z_seen, live, name=name, param=cfg.aggregator_param,
        backend=cfg.engine_backend, mesh=mesh, blocks=blocks)


def live_mask_rows(u: torch.Tensor, live) -> torch.Tensor:
    """Zero the participation row of evicted agents (``live`` an
    ``(N,)`` 0/1 row; None returns ``u`` unchanged)."""
    if live is None:
        return u
    return u * live_row(live, u.numel(), u.device)


def fusible_prox(prox_h: ProxH) -> bool:
    """Whether ``prox_h`` may run inside the fused edge kernels: h = 0 or
    a :func:`repro_torch.core.prox.make_prox` table entry (tagged
    ``elementwise``, with a kernel form)."""
    return prox_h is None or getattr(prox_h, "elementwise", False)


def _uniform_stack(*trees) -> bool:
    leaves = [l for t in trees for l in pytree.tree_leaves(t)]
    return len({(l.shape[0], l.dtype) for l in leaves}) == 1


# ---------------------------------------------------------------------------
# Mesh plumbing (the mesh contract in the module docstring)
# ---------------------------------------------------------------------------

def validate_mesh(cfg: RoundConfig, mesh,
                  local_solver: SolverAssignment = None) -> None:
    """Screening of a sharded round: the mesh's agent axis must evenly
    partition the agent axis and agree with ``cfg.agent_shards`` when
    that was pinned; every solver-group boundary of ``local_solver`` must
    land on a shard boundary (a rank runs the groups that own its
    rows)."""
    shards = mesh_agent_shards(mesh)
    if cfg.n_agents % shards:
        raise ValueError(
            f"n_agents={cfg.n_agents} is not divisible by the mesh's "
            f"agent axis ({shards} shards): every shard owns an equal "
            f"contiguous row block -- choose n_agents a multiple of "
            f"the shard count or shrink the mesh")
    if cfg.agent_shards > 1 and cfg.agent_shards != shards:
        raise ValueError(
            f"RoundConfig.agent_shards={cfg.agent_shards} but the mesh "
            f"has {shards} agent shards: drop one of the two or make "
            f"them agree")
    if (shards > 1 and local_solver is not None
            and not callable(local_solver)
            and not isinstance(local_solver, SolverGroup)):
        rows = cfg.n_agents // shards
        start = 0
        for g_idx, grp in enumerate(tuple(local_solver)[:-1]):
            start += grp.size
            if start % rows:
                raise ValueError(
                    f"solver group {g_idx} ends at agent {start}, "
                    f"inside an agent shard: with {shards} shards of "
                    f"{rows} agents each, group boundaries must be "
                    f"multiples of {rows} -- resize the groups or "
                    f"change the shard count")


def _packed_prox(zbar: torch.Tensor, meta, prox_h: ProxH, rho_eff: float,
                 mesh=None):
    """``y = prox(zbar)`` on the ``(1, width)`` coordinator buffer; a
    non-elementwise prox sees the coordinator-sized tree.  Under a
    ``mesh`` whose model axis splits the columns, ``zbar`` is this rank's
    column block: such a prox gathers the row over the model group and
    the result is cut back to the block."""
    if prox_h is None:
        return zbar
    if getattr(prox_h, "elementwise", False):
        return prox_h(zbar, rho_eff)
    full = (zbar if mesh is None
            else sharding.model_gather(zbar, mesh, meta.width))
    y = compress_lib.pack_coord(
        tree_map(lambda l: prox_h(l, rho_eff),
                 compress_lib.unpack_coord(full, meta)), meta)
    return y if mesh is None else sharding.col_block(y, mesh).contiguous()


def _uplink_sharded_torch(cfg: RoundConfig, z: torch.Tensor,
                          z_seen: torch.Tensor, meta, prox_h: ProxH, mesh):
    """Sharded packed uplink, torch backend (the reference's
    ``_uplink_sharded_xla``): local column sums, one all-reduce of the
    ``(1, width)`` partials, ``/ N`` (a division, as ``torch.mean``
    takes it), the prox at coordinator size on every rank, and the local
    reflection.  Also the path of a non-elementwise prox under a mesh."""
    zbar = sharding.agent_sum(torch.sum(z_seen, dim=0, keepdim=True),
                              mesh).div_(cfg.n_agents)
    y = _packed_prox(zbar, meta, prox_h, cfg.rho / cfg.n_agents, mesh)
    return y, 2.0 * y - z


def _tree_uplink_sharded(cfg: RoundConfig, z: Any, z_seen: Any,
                         prox_h: ProxH, mesh, blocks=None) -> Tuple[Any, Any]:
    """Sharded uplink on agent-stacked trees: per-leaf local sums, one
    all-reduce per leaf, ``/ N``; the ``y`` leaves are complete after the
    reduction, so any per-leaf prox applies unchanged -- or, under leaf
    ``blocks``, an elementwise one; another gathers each split leaf over
    the model group, applies the prox and keeps the block."""
    y = tree_map(lambda sl: sharding.agent_sum(torch.sum(sl, dim=0),
                                               mesh).div_(cfg.n_agents),
                 z_seen)
    if prox_h is not None:
        rho_eff = cfg.rho / cfg.n_agents
        if blocks is None or getattr(prox_h, "elementwise", False):
            y = tree_map(lambda l: prox_h(l, rho_eff), y)
        else:
            y = {n: blocks.block(n, prox_h(blocks.gather(n, l, 0), rho_eff),
                                 0).contiguous() for n, l in y.items()}
    return y, reflect(y, z)


# ---------------------------------------------------------------------------
# Round edges on trees
# ---------------------------------------------------------------------------

def coordinator_edge(cfg: RoundConfig, z: Any, z_seen: Any,
                     prox_h: ProxH = None, mesh=None,
                     blocks=None) -> Tuple[Any, Any]:
    """The uplink: ``y = prox_{rho h/N}(mean_i z_seen_i)`` and
    ``v = 2 y - z``.  Under the fused backend the leaves are packed and
    the edge is one :mod:`repro_torch.kernels.round_edge` launch.  With a
    ``mesh`` the same edge runs on this rank's row block, and on each
    leaf's block under ``blocks`` (mesh contract: module docstring)."""
    if cfg.fused and fusible_prox(prox_h) and _uniform_stack(z, z_seen):
        buf_z, meta = compress_lib.pack_leaves(z)
        buf_t = None if z_seen is z else compress_lib.pack_leaves(
            z_seen, meta)[0]
        rho_eff = cfg.rho / cfg.n_agents
        if mesh is not None:
            y_buf, v_buf = edge_ops.round_uplink_sharded(
                buf_z, buf_t, mesh=mesh, n_total=cfg.n_agents, prox=prox_h,
                rho_eff=rho_eff)
        else:
            y_buf, v_buf = edge_ops.round_uplink(buf_z, buf_t, prox=prox_h,
                                                 rho_eff=rho_eff)
        return (compress_lib.unpack_coord(y_buf, meta),
                compress_lib.unpack_leaves(v_buf, meta))
    if mesh is not None:
        return _tree_uplink_sharded(cfg, z, z_seen, prox_h, mesh, blocks)
    y = coordinator_prox(z_seen, cfg, prox_h)
    return y, reflect(y, z)


def agent_edge(cfg: RoundConfig, u: torch.Tensor, w: Any, x: Any, z: Any,
               y: Any, z_seen: Any = None, prox_h: ProxH = None,
               mesh=None) -> Tuple[Any, Any]:
    """The downlink: ``z + 2 damping (w - y)`` and the participation
    selects of ``x`` (from ``w``) and ``z``.  Under the fused backend one
    kernel launch on the packed buffers, which recomputes ``y`` from
    ``z_seen`` -- or, with a ``mesh``, consumes the replicated ``y``
    (``u`` is then this rank's block of the row).  The torch formula is
    row-local and consumes ``y``: it serves the mesh unchanged."""
    if z_seen is None:
        z_seen = z
    if cfg.fused and fusible_prox(prox_h) and _uniform_stack(x, w, z,
                                                             z_seen):
        x_buf, meta = compress_lib.pack_leaves(x)
        w_buf = compress_lib.pack_leaves(w, meta)[0]
        z_buf = compress_lib.pack_leaves(z, meta)[0]
        if mesh is not None:
            xb, zb = edge_ops.round_downlink_presummed(
                x_buf, w_buf, z_buf, compress_lib.pack_coord(y, meta), u,
                damping=cfg.damping)
        else:
            t_buf = None if z_seen is z else compress_lib.pack_leaves(
                z_seen, meta)[0]
            xb, zb = edge_ops.round_downlink(
                x_buf, w_buf, z_buf, u, t_buf, prox=prox_h,
                rho_eff=cfg.rho / cfg.n_agents, damping=cfg.damping)
        return (compress_lib.unpack_leaves(xb, meta),
                compress_lib.unpack_leaves(zb, meta))
    x_new = masked_mix(u, w, x)
    z_upd = tree_map(
        lambda zl, wl, yl: zl + 2.0 * cfg.damping * (wl - yl[None]),
        z, w, y)
    return x_new, masked_mix(u, z_upd, z)


# ---------------------------------------------------------------------------
# Round edges on the resident packed buffer
# ---------------------------------------------------------------------------

def coordinator_edge_packed(cfg: RoundConfig, z: torch.Tensor,
                            z_seen: torch.Tensor, meta,
                            prox_h: ProxH = None, mesh=None):
    """:func:`coordinator_edge` on ``(N, width)`` buffers; returns
    ``(y (1, width), v)``.  A non-elementwise prox sees the
    coordinator-sized tree through ``unpack_coord`` / ``pack_coord``.
    With a ``mesh`` the buffers are this rank's row block."""
    rho_eff = cfg.rho / cfg.n_agents
    lagged = None if z_seen is z else z_seen
    if mesh is not None:
        if cfg.fused and fusible_prox(prox_h):
            return edge_ops.round_uplink_sharded(
                z, lagged, mesh=mesh, n_total=cfg.n_agents, prox=prox_h,
                rho_eff=rho_eff)
        return _uplink_sharded_torch(cfg, z, z_seen, meta, prox_h, mesh)
    if cfg.fused and fusible_prox(prox_h):
        return edge_ops.round_uplink(z, lagged, prox=prox_h,
                                     rho_eff=rho_eff)
    zbar = torch.mean(z_seen, dim=0, keepdim=True)
    y = _packed_prox(zbar, meta, prox_h, rho_eff)
    return y, 2.0 * y - z


def agent_edge_packed(cfg: RoundConfig, u: torch.Tensor, w: torch.Tensor,
                      x: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                      z_seen: torch.Tensor, prox_h: ProxH = None,
                      mesh=None):
    """:func:`agent_edge` on ``(N, width)`` buffers (``y`` the
    ``(1, width)`` coordinator buffer).  With a ``mesh`` the fused
    backend is one presummed launch on this rank's rows; the torch
    formula (the reference's ``_downlink_sharded_xla`` under a mesh) is
    row-local and serves both."""
    if cfg.fused and fusible_prox(prox_h):
        if mesh is not None:
            return edge_ops.round_downlink_presummed(x, w, z, y, u,
                                                     damping=cfg.damping)
        return edge_ops.round_downlink(
            x, w, z, u, None if z_seen is z else z_seen, prox=prox_h,
            rho_eff=cfg.rho / cfg.n_agents, damping=cfg.damping)
    mask = (u != 0).reshape(-1, 1)
    x_new = torch.where(mask, w, x)
    z_upd = z + 2.0 * cfg.damping * (w - y)
    return x_new, torch.where(mask, z_upd, z)


# ---------------------------------------------------------------------------
# Solvers and rounds
# ---------------------------------------------------------------------------

def group_rows(sizes, n_agents: int, rows: Optional[slice] = None):
    """``[(g, local, agents)]`` for each group (``sizes`` in order) that
    owns agents of the block ``rows`` (a global row slice; None = all
    ``n_agents``): ``local`` its rows in the block, ``agents`` the same
    rows as global agent indices."""
    lo, hi = (0, n_agents) if rows is None else (rows.start, rows.stop)
    out, start = [], 0
    for g, size in enumerate(sizes):
        a, b = max(start, lo), min(start + size, hi)
        if a < b:
            out.append((g, slice(a - lo, b - lo), slice(a, b)))
        start += size
    return out


def other_rank_solver(x, v):
    """The solver a sharded round's front end gives a group whose rows
    other ranks hold: :func:`run_solvers` never calls it."""
    raise RuntimeError("a solver group of another rank's rows was run")


def _take_rows(tree: Any, rows: slice) -> Any:
    return tree_map(lambda l: l[rows], tree)


def run_solvers(local_solver: SolverAssignment, x: Any, v: Any,
                n_agents: int, mesh=None) -> Tuple[Any, Any]:
    """Run the round's solver assignment on the reflected states.

    One solver (or a single :class:`SolverGroup`) is called on the whole
    stack, exactly as an ungrouped round.  Several groups partition the
    agent axis contiguously: group ``g`` solves its rows, in group order,
    and writes them into ONE output buffer shaped like ``x`` -- a solver
    that takes ``out=`` (the core solvers: ``solver.takes_out``) writes
    its iterate there directly, any other solver's rows are copied in and
    freed -- so no concatenation holds a second state-sized buffer.
    ``aux`` is the solver's own aux when there is one group, else the
    tuple of the per-group auxes (None when every group returned None),
    in group order.  Under a ``mesh`` ``x`` and ``v`` are this rank's row
    block and only the groups that own its rows run (``aux`` then holds
    theirs)."""
    if isinstance(local_solver, SolverGroup):
        local_solver = (local_solver,)
    if callable(local_solver):
        return local_solver(x, v)
    groups = tuple(local_solver)
    if sum(g.size for g in groups) != n_agents:
        raise ValueError(f"solver groups cover {sum(g.size for g in groups)}"
                         f" agents, round has n_agents={n_agents}")
    if len(groups) == 1:
        return groups[0].solver(x, v)
    rows = None if mesh is None else sharding.agent_rows(mesh, n_agents)
    w = tree_map(torch.empty_like, x)
    auxs = []
    for g, local, _ in group_rows([grp.size for grp in groups], n_agents,
                                  rows):
        solver = groups[g].solver
        out = _take_rows(w, local)
        args = (_take_rows(x, local), _take_rows(v, local))
        if getattr(solver, "takes_out", False):
            _, aux = solver(*args, out=out)
        else:
            w_g, aux = solver(*args)
            tree_map(lambda o, s: o.copy_(s), out, w_g)
            del w_g
        auxs.append(aux)
    return w, (None if all(a is None for a in auxs) else tuple(auxs))


def _round_rows(cfg: RoundConfig, mesh, u, corrupt, live, device,
                generator):
    """This rank's ``(u, corrupt)``: the participation row drawn (or
    replayed) over all N agents -- every rank draws the same row from its
    identically seeded generator -- masked by ``live``, then both rows
    sliced to this rank's block (the whole row without a mesh)."""
    u = participation_mask(cfg, device, generator, u)
    u = sharding.fed_row_spec(live_mask_rows(u, live), mesh, cfg.n_agents)
    return u, sharding.fed_row_spec(corrupt, mesh, cfg.n_agents)


def packed_round_step(cfg: RoundConfig, meta, x: torch.Tensor,
                      z: torch.Tensor, t: torch.Tensor,
                      local_solver: SolverAssignment, prox_h: ProxH = None,
                      *, generator=None, u=None, corrupt=None,
                      live=None, mesh=None) -> RoundResult:
    """One round on the resident packed state (``(N, width)`` buffers laid
    out by ``meta``); mirrors :func:`round_step`.  ``u`` replays a given
    ``(N,)`` participation row instead of drawing one; ``corrupt`` and
    ``live`` are fault rows (see :func:`round_step`).  With a ``mesh`` the
    buffers are this rank's block -- its agent rows and, where the model
    axis splits them, its columns -- and the rows stay global (mesh
    contract: module docstring)."""
    if mesh is not None:
        validate_mesh(cfg, mesh, local_solver=local_solver)
    z_seen = t if cfg.compressed else z
    z_seen = robust_seen(cfg, z_seen, live, meta, mesh)
    y, v = coordinator_edge_packed(cfg, z, z_seen, meta, prox_h, mesh)
    w, aux = run_solvers(local_solver, x, v, cfg.n_agents, mesh)
    del v
    u, corrupt = _round_rows(cfg, mesh, u, corrupt, live, x.device,
                             generator)
    w = apply_corruption(w, corrupt)
    u, _ok = increment_guard(cfg, w, u, meta, mesh)
    x_new, z_new = agent_edge_packed(cfg, u, w, x, z, y, z_seen, prox_h,
                                     mesh)
    del w
    t_new = z_new
    if cfg.compressed:
        q = compress_lib.compress_increment_packed(z_new - t, meta, cfg,
                                                   mesh)
        t_new = t.addcmul_(u.to(q.dtype).reshape(-1, 1), q)
    return RoundResult(x=x_new, z=z_new, t=t_new, y=y, u=u, aux=aux)


def round_step(cfg: RoundConfig, x: Any, z: Any, t: Any,
               local_solver: SolverAssignment, prox_h: ProxH = None, *,
               generator=None, u=None, corrupt=None, live=None,
               mesh=None, blocks=None) -> RoundResult:
    """One Fed-PLT round on agent-stacked trees.  ``t`` is the
    coordinator's copy of ``z`` (``z`` itself when the exchange is
    uncompressed; advanced in place when compressed).  ``u`` replays a
    given participation row.  ``corrupt`` is a recorded corruption row
    applied to the solvers' output (:func:`apply_corruption`, screened by
    :func:`increment_guard` when guards are on); ``live`` drops evicted
    agents from the participation row and from the coordinator's
    aggregate.  ``None`` for both runs the fault-free round.  With a
    ``mesh`` the trees hold this rank's row block, the ``(N,)`` rows stay
    global, and the result's ``u`` is this rank's block; under a model
    axis ``blocks`` places each leaf's block (module docstring)."""
    if mesh is not None:
        validate_mesh(cfg, mesh, local_solver=local_solver)
    z_seen = t if cfg.compressed else z
    z_seen = robust_seen(cfg, z_seen, live, mesh=mesh, blocks=blocks)
    y, v = coordinator_edge(cfg, z, z_seen, prox_h, mesh, blocks)
    w, aux = run_solvers(local_solver, x, v, cfg.n_agents, mesh)
    del v
    u, corrupt = _round_rows(cfg, mesh, u, corrupt, live,
                             pytree.tree_leaves(x)[0].device, generator)
    w = apply_corruption(w, corrupt)
    u, _ok = increment_guard(cfg, w, u, blocks=blocks)
    x_new, z_new = agent_edge(cfg, u, w, x, z, y, z_seen, prox_h, mesh)
    del w
    t_new = z_new
    if cfg.compressed:
        q = compress_lib.compress_increment(tree_map(torch.sub, z_new, t),
                                            cfg, blocks)
        t_new = tree_map(
            lambda tl, ql: tl.addcmul_(
                u.to(ql.dtype).reshape((-1,) + (1,) * (ql.ndim - 1)), ql),
            t, q)
    return RoundResult(x=x_new, z=z_new, t=t_new, y=y, u=u, aux=aux)
