"""One front door for Fed-PLT: ``FedSpec`` + ``build_trainer``
(counterpart of ``repro/fed/api.py``): a dense problem (``local_loss`` +
``n_agents``, :mod:`repro_torch.core.problem`) gets the paper-faithful
:class:`DenseTrainer` over :class:`repro_torch.core.fedplt.FedPLT`, a
model (``init`` + ``loss_fn``) the model-scale :class:`ModelTrainer`.

``FedSpec`` keeps the reference's field names and defaults, so one spec
reads the same in both packages, with two renames for the port's
backends: ``engine_backend`` is ``"torch"`` (the reference's ``"xla"``,
unfused tensor ops) or ``"fused"`` (its ``"pallas"``, the
:mod:`repro_torch.kernels.round_edge` kernels), and ``use_pallas`` is
``use_fused_update`` (the :mod:`repro_torch.kernels.fedplt_update`
kernel); ``CompressionSpec.backend`` likewise takes ``"torch"`` or
``"fused"`` (the :mod:`repro_torch.kernels.compress` kernels) besides
``"auto"``.  The fault and robust fields (``guard_increments``,
``guard_norm_bound``, ``aggregator``, ``aggregator_param``) mean what they
mean in the reference; under ``engine_backend="fused"`` the order-statistic
aggregators run the :mod:`repro_torch.kernels.robust_agg` kernel.
``agent_shards`` / ``mesh_shape`` shard the agent axis over an
``("agent", "model")`` mesh of processes (:mod:`repro_torch.launch.mesh`,
one process per rank under torchrun; a 1x1 mesh runs in the caller's
process); a model extent above 1 (``"AxM"``) also splits each agent's
batch over the model ranks and the state: a packed buffer's columns, or
in the tree layout each leaf's tensor-parallel dim (the reference's
per-leaf ``param_specs``).  ``async_mode="stale"`` with ``max_staleness``
K runs bounded-staleness async rounds (:mod:`repro_torch.fed.async_engine`;
:func:`effective_privacy_report` composes over a realised schedule).
``agent_groups`` (:class:`AgentGroupSpec`, or the CLI grammar of
:func:`parse_agent_groups`) partitions the agent axis into contiguous
groups, each with its own registered solver, ``n_epochs``, ``gamma`` and
participation (the engine's :func:`repro_torch.fed.engine.run_solvers`);
:func:`privacy_report` then gives the per-agent ``(eps_i, delta)`` table.

The train CLI is generated from the spec's dataclass fields
(:func:`add_spec_args` / :func:`spec_from_args`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch import resolve_device
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import prox as prox_lib
from repro_torch.core.solvers import SolverConfig
from repro_torch.fed import engine, sharding
from repro_torch.fed.compress import (COMPRESS_BACKENDS,
                                      available_compressors, get_compressor)
from repro_torch.fed.robust import validate_aggregator
from repro_torch.fed.solvers import get_solver


def _upgrade_solver(name: str, tau: float) -> str:
    """tau > 0 turns the gd-type solvers into DP noisy GD; any other
    solver is rejected under tau > 0 (the Prop. 4 accountant certifies
    noisy local GD only)."""
    if tau > 0.0:
        if name in ("gd", "sgd"):
            return "noisy_gd"
        if name != "noisy_gd":
            raise ValueError("DP noise (tau > 0) requires a gd-type "
                             f"solver, not {name!r}")
    return name


def _cli(flag=None, help="", arg_type=None, choices=None, default=None,
         expose=True):
    """Field metadata driving the generated argparse flags (``default``
    overrides the dataclass default on the CLI only)."""
    return {"cli": {"flag": flag, "help": help, "type": arg_type,
                    "choices": choices, "default": default,
                    "expose": expose}}


def _save(trainer, path: str, state, **kw) -> None:
    """:func:`repro_torch.checkpoint.io.save_checkpoint` of a trainer's
    state.  Under a mesh every rank calls this with its block: each
    tensor field is gathered as ``trainer._placement`` says (a collective
    over both groups), rank 0 writes the global state, and a barrier
    follows before any rank reads."""
    if trainer.mesh is None:
        ckpt.save_checkpoint(path, state, **kw)
        return
    mesh, n_agents = trainer.mesh, trainer.spec.n_agents
    gathered = {}
    for f, v in zip(state._fields, state):
        if isinstance(v, torch.Tensor):
            gathered[f] = sharding.gather_block(
                v, mesh, n_agents, **trainer._placement("." + f))
        elif isinstance(v, dict):
            gathered[f] = {n: sharding.gather_block(
                t, mesh, n_agents,
                **trainer._placement(f".{f}/" + n.replace(".", "/")))
                for n, t in v.items()}
    state = state._replace(**gathered)
    err = None
    if dist.get_rank() == 0:
        try:
            ckpt.save_checkpoint(path, state, **kw)
        except Exception as e:          # the barrier first, then raise
            err = e
    dist.barrier()
    if err is not None:
        raise err


def _own(trainer):
    """This rank's block of a global leaf (the inverse of the gather in
    :func:`_save`), or None without a mesh."""
    if trainer.mesh is None:
        return None
    return lambda key, full: sharding.own_block(
        full, trainer.mesh, trainer.spec.n_agents,
        **trainer._placement(key))


def _restore_generator(path: str, generator) -> dict:
    """The checkpoint's ``extra``; its ``generator`` state, when there is
    one, is set into ``generator``."""
    extra = ckpt.checkpoint_extra(path) or {}
    if generator is not None and "generator" in extra:
        ckpt.set_generator_state(generator, extra["generator"])
    return extra


# ---------------------------------------------------------------------------
# Component specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """DP knobs (paper Section VI)."""

    tau: float = dataclasses.field(default=0.0, metadata=_cli(
        help="DP noise std (tau > 0 turns gd-type solvers into noisy GD)"))
    clip: Optional[float] = dataclasses.field(default=None, metadata=_cli(
        arg_type=float,
        help="per-agent gradient clip threshold C (DP sensitivity)"))
    delta: float = dataclasses.field(default=1e-5, metadata=_cli(
        help="ADP delta for the privacy report"))
    dp_init: bool = dataclasses.field(default=False, metadata=_cli(
        expose=False))


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """z-uplink compression; ``name`` is a
    :mod:`repro_torch.fed.compress` registry entry."""

    name: str = dataclasses.field(default="none", metadata=_cli(
        flag="--compression", help="z-uplink compressor (registry name)"))
    ratio: float = dataclasses.field(default=0.25, metadata=_cli(
        flag="--compress-ratio",
        help="top-k fraction kept (floor for adaptive_topk)"))
    energy: float = dataclasses.field(default=0.95, metadata=_cli(
        flag="--compress-energy",
        help="adaptive_topk per-agent energy target"))
    backend: str = dataclasses.field(default="auto", metadata=_cli(
        flag="--compress-backend", choices=list(COMPRESS_BACKENDS),
        help="uplink compressor backend (auto = the kernel wherever one "
             "exists; fused = the compress kernels)"))


@dataclasses.dataclass(frozen=True)
class AgentGroupSpec:
    """One contiguous group of agents with its own local-training recipe
    (the reference's).  ``None`` fields inherit the top-level
    :class:`FedSpec` value.  Groups partition the agent axis in order: the
    first owns agents ``[0, size)``, the next ``[size, size + size')``,
    and so on; the engine runs each group's registered solver on its rows
    (:func:`repro_torch.fed.engine.run_solvers`)."""

    size: int
    solver: Optional[str] = None         # repro_torch.fed.solvers name
    n_epochs: Optional[int] = None       # N_e of this group
    gamma: Optional[float] = None        # local step size of this group
    participation: Optional[float] = None  # Bernoulli p of this group


def parse_agent_groups(text: str) -> tuple:
    """Parse the CLI grammar for ``--agent-groups``: comma-separated
    groups, each ``SIZE[*SOLVER][:key=value]...`` with keys ``n_epochs`` /
    ``gamma`` / ``participation``; omitted pieces inherit the top-level
    spec.  Examples::

        2*gd,2*agd
        3*gd:participation=0.5,1*agd:n_epochs=1:gamma=0.02
    """
    groups = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            raise ValueError(f"empty agent group in {text!r}")
        head, *opts = part.split(":")
        if "*" in head:
            size_s, solver = head.split("*", 1)
            solver = solver.strip() or None
        else:
            size_s, solver = head, None
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(
                f"agent group {part!r} must start with an integer size "
                f"(grammar: SIZE[*SOLVER][:key=value]...)") from None
        kw = {}
        for opt in opts:
            k, sep, val = opt.partition("=")
            k = k.strip()
            if not sep or k not in ("n_epochs", "gamma", "participation"):
                raise ValueError(
                    f"unknown agent-group option {opt!r} in {part!r} "
                    f"(known: n_epochs=, gamma=, participation=)")
            kw[k] = int(val) if k == "n_epochs" else float(val)
        groups.append(AgentGroupSpec(size=size, solver=solver, **kw))
    return tuple(groups)


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedSpec:
    """Composable Fed-PLT specification -- the one front-door config."""

    # -- round topology --------------------------------------------------
    n_agents: Optional[int] = dataclasses.field(default=None, metadata=_cli(
        arg_type=int, default=4, help="number of agents"))
    rho: float = dataclasses.field(default=1.0, metadata=_cli(
        help="proximal penalty rho of Algorithm 1"))
    participation: float = dataclasses.field(default=1.0, metadata=_cli(
        help="per-agent Bernoulli participation probability p"))
    damping: float = dataclasses.field(default=1.0, metadata=_cli(
        help="Krasnosel'skii relaxation (1 = PRS, 0.5 = Douglas-Rachford)"))
    # -- local solver ----------------------------------------------------
    solver: str = dataclasses.field(default="gd", metadata=_cli(
        choices=["gd", "agd", "sgd"],
        help="local solver (tau > 0 upgrades gd-type to noisy_gd)"))
    n_epochs: int = dataclasses.field(default=5, metadata=_cli(
        help="local epochs N_e per round"))
    gamma: Optional[float] = dataclasses.field(default=None, metadata=_cli(
        arg_type=float, default=0.05,
        help="local step size (required at model scale)"))
    mu: Optional[float] = dataclasses.field(default=None,
                                            metadata=_cli(expose=False))
    L: Optional[float] = dataclasses.field(default=None,
                                           metadata=_cli(expose=False))
    batch_size: Optional[int] = dataclasses.field(
        default=None, metadata=_cli(expose=False))
    uncoordinated: bool = dataclasses.field(
        default=False, metadata=_cli(expose=False))
    # -- heterogeneous agent groups -------------------------------------
    # None = every agent runs the top-level solver / n_epochs / gamma /
    # participation; a tuple of AgentGroupSpec partitions the agent axis
    agent_groups: Optional[tuple] = dataclasses.field(
        default=None, metadata=_cli(
            arg_type=parse_agent_groups,
            help="heterogeneous agent groups, e.g. "
                 "'2*gd,2*agd:n_epochs=1:gamma=0.02' (sizes must sum to "
                 "n-agents; omitted knobs inherit the top-level spec)"))
    # -- coordinator regularizer h --------------------------------------
    prox_h: str = dataclasses.field(default="zero",
                                    metadata=_cli(expose=False))
    weight_decay: float = dataclasses.field(default=0.0, metadata=_cli(
        help="coordinator l2 regularizer h (prox_h='weight_decay')"))
    # -- composed specs --------------------------------------------------
    privacy: PrivacySpec = dataclasses.field(default_factory=PrivacySpec)
    compression: CompressionSpec = dataclasses.field(
        default_factory=CompressionSpec)
    # -- execution -------------------------------------------------------
    use_fused_update: bool = dataclasses.field(default=False, metadata=_cli(
        flag="--use-fused-update",
        help="fused fedplt_update kernel for the local step"))
    engine_backend: str = dataclasses.field(default="torch", metadata=_cli(
        flag="--engine-backend", choices=list(engine.ENGINE_BACKENDS),
        help="round-edge backend (fused = the round_edge kernels)"))
    state_layout: str = dataclasses.field(default="tree", metadata=_cli(
        flag="--state-layout", choices=list(engine.ENGINE_LAYOUTS),
        help="round-to-round state representation (packed = one "
             "resident agent-axis buffer)"))
    async_mode: str = dataclasses.field(default="off", metadata=_cli(
        flag="--async-mode", choices=["off", "stale"],
        help="async round mode (stale = bounded-staleness arrivals; "
             "off = bulk-synchronous rounds)"))
    max_staleness: int = dataclasses.field(default=0, metadata=_cli(
        flag="--max-staleness", arg_type=int,
        help="staleness bound K: an agent holding K-round-old work is "
             "forced to arrive (0 = synchronous semantics)"))
    guard_increments: bool = dataclasses.field(default=False, metadata=_cli(
        flag="--guard-increments",
        help="screen agent increments in the round: a non-finite (or "
             "over-norm) uplink row becomes a non-arrival this round"))
    guard_norm_bound: float = dataclasses.field(
        default=float("inf"), metadata=_cli(
            flag="--guard-norm-bound", arg_type=float,
            help="l2 norm bound for --guard-increments (inf = "
                 "finiteness-only screen)"))
    aggregator: str = dataclasses.field(default="mean", metadata=_cli(
        flag="--aggregator",
        help="coordinator aggregator (repro_torch.fed.robust registry "
             "name; mean = the fault-free uplink)"))
    aggregator_param: float = dataclasses.field(
        default=0.0, metadata=_cli(
            flag="--aggregator-param", arg_type=float,
            help="aggregator parameter: trim count f for trimmed_mean, "
                 "clip radius for norm_clip_mean"))
    agent_shards: int = dataclasses.field(default=1, metadata=_cli(
        flag="--agent-shards", arg_type=int,
        help="shard the round's agent axis across this many devices, one "
             "process each (n-agents must divide evenly; 1 = unsharded)"))
    mesh_shape: Optional[str] = dataclasses.field(default=None, metadata=_cli(
        flag="--mesh-shape", arg_type=str,
        help="explicit AGENTSxMODEL device mesh, e.g. '2x1', or '1x2' / "
             "'2x2' with a model axis (packed layout: each model rank "
             "holds a column block of the state and a share of each "
             "agent's batch); default agent-shards x 1"))

    def __post_init__(self):
        groups = self.agent_groups
        if groups is not None:
            if isinstance(groups, str):
                groups = parse_agent_groups(groups)
            object.__setattr__(self, "agent_groups", tuple(groups))

    # ------------------------------------------------------------------
    # Resolution
    # ------------------------------------------------------------------
    def solver_name(self) -> str:
        return _upgrade_solver(self.solver, self.privacy.tau)

    def solver_config(self) -> SolverConfig:
        return SolverConfig(name=self.solver_name(),
                            n_epochs=self.n_epochs, step_size=self.gamma,
                            tau=self.privacy.tau, clip=self.privacy.clip)

    def resolved_groups(self) -> Optional[tuple]:
        """``agent_groups`` with every None field filled from the
        top-level spec (None when the spec is homogeneous)."""
        if self.agent_groups is None:
            return None
        return tuple(AgentGroupSpec(
            size=g.size,
            solver=g.solver if g.solver is not None else self.solver,
            n_epochs=(g.n_epochs if g.n_epochs is not None
                      else self.n_epochs),
            gamma=g.gamma if g.gamma is not None else self.gamma,
            participation=(g.participation if g.participation is not None
                           else self.participation))
            for g in self.agent_groups)

    def group_solver_configs(self) -> Optional[tuple]:
        """Per-group :class:`SolverConfig` (tau > 0 upgrades gd-type
        groups to noisy GD, as the homogeneous path does)."""
        groups = self.resolved_groups()
        if groups is None:
            return None
        return tuple(SolverConfig(
            name=_upgrade_solver(g.solver, self.privacy.tau),
            n_epochs=g.n_epochs, step_size=g.gamma,
            tau=self.privacy.tau, clip=self.privacy.clip)
            for g in groups)

    def participation_schedule(self) -> Union[float, tuple]:
        """Engine participation: the scalar p, or the per-agent ``(N,)``
        tuple expanded from the groups when any group deviates."""
        groups = self.resolved_groups()
        if groups is None or all(
                g.participation == self.participation for g in groups):
            return self.participation
        out = []
        for g in groups:
            out.extend([float(g.participation)] * g.size)
        return tuple(out)

    def round_config(self) -> engine.RoundConfig:
        if self.n_agents is None:
            raise ValueError("FedSpec.n_agents is unresolved (set it "
                             "explicitly at model scale)")
        return engine.RoundConfig(
            n_agents=self.n_agents, rho=self.rho,
            participation=self.participation_schedule(),
            damping=self.damping,
            compression=self.compression.name,
            compress_ratio=self.compression.ratio,
            compress_energy=self.compression.energy,
            compress_backend=self.compression.backend,
            engine_backend=self.engine_backend,
            state_layout=self.state_layout,
            staleness=self.staleness_config(),
            guard_increments=self.guard_increments,
            guard_norm_bound=self.guard_norm_bound,
            aggregator=self.aggregator,
            aggregator_param=self.aggregator_param,
            agent_shards=self.resolved_agent_shards())

    def staleness_config(self) -> engine.StalenessConfig:
        """The async-round knobs (mode "off" = synchronous rounds)."""
        return engine.StalenessConfig(mode=self.async_mode,
                                      max_staleness=self.max_staleness)

    def mesh_axes(self) -> Optional[tuple]:
        """The ``(agent, model)`` mesh extents this spec denotes, or None
        when the run is unsharded.  ``mesh_shape`` wins when set (and must
        agree with a non-default ``agent_shards``)."""
        if self.mesh_shape is None:
            if self.agent_shards == 1:
                return None
            return (self.agent_shards, 1)
        parts = self.mesh_shape.lower().split("x")
        if len(parts) != 2:
            raise ValueError(
                f"mesh_shape must be 'AGENTSxMODEL' (e.g. '8x1'), got "
                f"{self.mesh_shape!r}")
        try:
            a, m = (int(p) for p in parts)
        except ValueError:
            raise ValueError(
                f"mesh_shape extents must be integers, got "
                f"{self.mesh_shape!r}") from None
        if a < 1 or m < 1:
            raise ValueError(f"mesh_shape extents must be >= 1, got "
                             f"{self.mesh_shape!r}")
        if self.agent_shards != 1 and self.agent_shards != a:
            raise ValueError(
                f"agent_shards={self.agent_shards} disagrees with "
                f"mesh_shape={self.mesh_shape!r} (agent extent {a}); "
                f"set one, or make them agree")
        return (a, m)

    def resolved_agent_shards(self) -> int:
        """The agent-axis device count the engine validates against (1
        when unsharded)."""
        axes = self.mesh_axes()
        return 1 if axes is None else axes[0]

    def build_mesh(self, device=None):
        """The :class:`torch.distributed.device_mesh.DeviceMesh` this spec
        denotes on ``device``'s type (CUDA unless the CPU is asked for), or
        None when unsharded.  Raises, naming torchrun, when the running
        process group does not hold ``agents x model`` ranks."""
        axes = self.mesh_axes()
        if axes is None:
            return None
        from repro_torch.launch.mesh import make_fed_mesh

        return make_fed_mesh(*axes, device=resolve_device(device))

    def moduli_for(self, gamma: Optional[float]):
        """(mu, L) of the local f_i; with ``gamma`` set an unknown L is
        1/gamma - 1/rho, so that agd's 1/L_d step equals gamma."""
        mu = self.mu if self.mu is not None else 0.0
        if self.L is not None:
            return mu, self.L
        if gamma is None:
            return mu, None
        return mu, 1.0 / gamma - 1.0 / self.rho

    def moduli(self):
        return self.moduli_for(self.gamma)

    def resolve_prox_h(self) -> engine.ProxH:
        """The coordinator regularizer's prox from the one
        :func:`repro_torch.core.prox.make_prox` table; None when h = 0."""
        if self.weight_decay != 0.0:
            return prox_lib.make_prox("weight_decay",
                                      weight=self.weight_decay)
        if self.prox_h == "zero":
            return None
        return prox_lib.make_prox(self.prox_h)

    # ------------------------------------------------------------------
    # Validation
    # ------------------------------------------------------------------
    def validate(self) -> "FedSpec":
        """Raise ValueError on any inconsistent combination; returns
        self."""
        if self.n_agents is not None and self.n_agents < 1:
            raise ValueError("n_agents must be >= 1")
        if self.rho <= 0.0:
            raise ValueError("rho must be positive")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if not 0.0 < self.damping <= 1.0:
            raise ValueError("damping must be in (0, 1]")
        if self.n_epochs < 1:
            raise ValueError("n_epochs must be >= 1")
        if self.gamma is not None and self.gamma <= 0.0:
            raise ValueError("gamma must be positive")
        p = self.privacy
        if p.tau < 0.0:
            raise ValueError("tau must be >= 0")
        if p.clip is not None and p.clip <= 0.0:
            raise ValueError("clip must be positive (clip=0 zeroes every "
                             "gradient; use None to disable clipping)")
        if not 0.0 < p.delta < 1.0:
            raise ValueError("delta must be in (0, 1)")
        name = self.solver_name()   # raises for agd + tau > 0
        get_solver(name)
        get_compressor(self.compression.name)
        if not 0.0 < self.compression.ratio <= 1.0:
            raise ValueError("compress ratio must be in (0, 1]")
        if not 0.0 < self.compression.energy <= 1.0:
            raise ValueError("compress energy must be in (0, 1]")
        if self.compression.backend not in COMPRESS_BACKENDS:
            raise ValueError(
                f"unknown compress backend {self.compression.backend!r}; "
                f"known: {', '.join(COMPRESS_BACKENDS)}")
        if self.engine_backend not in engine.ENGINE_BACKENDS:
            raise ValueError(
                f"unknown engine backend {self.engine_backend!r}; "
                f"known: {', '.join(engine.ENGINE_BACKENDS)}")
        if self.state_layout not in engine.ENGINE_LAYOUTS:
            raise ValueError(
                f"unknown state layout {self.state_layout!r}; "
                f"known: {', '.join(engine.ENGINE_LAYOUTS)}")
        self.staleness_config()     # bad mode / bound -> ValueError
        if not self.guard_norm_bound > 0.0:
            raise ValueError("guard_norm_bound must be positive (use "
                             "inf for a finiteness-only screen)")
        validate_aggregator(self.aggregator, self.aggregator_param,
                            self.n_agents)
        if self.weight_decay < 0.0:
            raise ValueError("weight_decay must be >= 0")
        if self.weight_decay != 0.0 and self.prox_h not in (
                "zero", "weight_decay"):
            raise ValueError("weight_decay and a non-trivial prox_h are "
                             "mutually exclusive (one coordinator h)")
        self.resolve_prox_h()
        if name == "agd":
            self._check_agd_moduli(self.gamma)
        self._validate_groups()
        self._validate_mesh()
        return self

    def _check_agd_moduli(self, gamma: Optional[float],
                          where: str = "") -> None:
        mu, L = self.moduli_for(gamma)
        if L is not None and L <= mu:
            if self.L is not None:
                raise ValueError(f"agd momentum needs L > mu (got "
                                 f"L={L:.4g}, mu={mu:.4g}){where}")
            raise ValueError(
                f"agd momentum needs L > mu; derived L={L:.4g} from "
                f"gamma={gamma} (needs gamma < rho/(1 + mu*rho) "
                f"= {self.rho / (1.0 + mu * self.rho):.4g}) -- pass "
                f"an explicit L in the spec{where}")

    def _validate_groups(self) -> None:
        groups = self.resolved_groups()
        if groups is None:
            return
        if not groups:
            raise ValueError("agent_groups must have at least one group "
                             "(use None for the homogeneous path)")
        for i, g in enumerate(groups):
            where = f" (agent group {i})"
            if g.size < 1:
                raise ValueError(f"agent group sizes must be >= 1, got "
                                 f"{g.size}{where}")
            gname = _upgrade_solver(g.solver, self.privacy.tau)
            get_solver(gname)
            if g.n_epochs < 1:
                raise ValueError(f"n_epochs must be >= 1{where}")
            if g.gamma is not None and g.gamma <= 0.0:
                raise ValueError(f"gamma must be positive{where}")
            if not 0.0 < g.participation <= 1.0:
                raise ValueError(
                    f"participation must be in (0, 1]{where}")
            if gname == "agd":
                self._check_agd_moduli(g.gamma, where)
        total = sum(g.size for g in groups)
        if self.n_agents is not None and total != self.n_agents:
            raise ValueError(
                f"agent_groups sizes sum to {total}, but "
                f"n_agents={self.n_agents} -- groups must partition the "
                f"agent axis")

    def _validate_mesh(self) -> None:
        if self.agent_shards < 1:
            raise ValueError(f"agent_shards must be >= 1, got "
                             f"{self.agent_shards}")
        shards = self.resolved_agent_shards()
        if self.n_agents is None:
            return
        self.round_config()     # checks n_agents against the shards
        groups = self.resolved_groups()
        if shards == 1 or groups is None:
            return
        rows = self.n_agents // shards
        edge = 0
        for i, g in enumerate(groups[:-1]):
            edge += g.size
            if edge % rows != 0:
                raise ValueError(
                    f"agent group {i} ends at row {edge}, which is "
                    f"not a multiple of the shard size {rows} "
                    f"(n_agents={self.n_agents} / agent_shards="
                    f"{shards}) -- a solver group may not straddle "
                    f"a device boundary; re-cut the groups or "
                    f"change the shard count")

    # ------------------------------------------------------------------
    # Legacy-config bridge
    # ------------------------------------------------------------------
    def to_dense_config(self):
        """The :class:`repro_torch.core.fedplt.FedPLTConfig` this spec
        denotes (inverse of ``FedPLTConfig.to_spec``); ``use_fused_update``
        has no counterpart there: the dense solver never fuses its step."""
        from repro_torch.core.fedplt import FedPLTConfig

        return FedPLTConfig(
            rho=self.rho,
            solver=self.solver_config(),
            participation=self.participation,
            prox_h=self.prox_h,
            batch_size=self.batch_size,
            mu=self.mu, L=self.L,
            dp_init=self.privacy.dp_init,
            uncoordinated=self.uncoordinated,
            compression=self.compression.name,
            compress_ratio=self.compression.ratio,
            compress_energy=self.compression.energy,
            compress_backend=self.compression.backend,
            engine_backend=self.engine_backend,
            state_layout=self.state_layout,
            damping=self.damping,
            async_mode=self.async_mode,
            max_staleness=self.max_staleness,
            guard_increments=self.guard_increments,
            guard_norm_bound=self.guard_norm_bound,
            aggregator=self.aggregator,
            aggregator_param=self.aggregator_param)


def as_spec(cfg: Any) -> FedSpec:
    """A FedSpec, or any config with ``.to_spec()`` (``FedPLTConfig``)."""
    if isinstance(cfg, FedSpec):
        return cfg
    to_spec = getattr(cfg, "to_spec", None)
    if to_spec is None:
        raise TypeError(f"cannot interpret {type(cfg).__name__} as a "
                        f"FedSpec (no .to_spec())")
    return to_spec()


# ---------------------------------------------------------------------------
# Privacy accounting from the spec
# ---------------------------------------------------------------------------

def _resolve_gamma(spec: FedSpec, gamma: Optional[float]) -> float:
    if gamma is not None:
        return gamma
    m, L = spec.moduli()
    if L is None:
        raise ValueError("privacy_report needs gamma (or explicit "
                         "moduli to derive it)")
    return spec.solver_config().resolve_step_size(
        m + 1.0 / spec.rho, L + 1.0 / spec.rho)


def _accounting(spec: Any, mu, delta, what: str):
    """``(spec, mu, delta)`` of a privacy report: the validated spec, the
    curvature charged (default weight_decay + 1/rho, the curvature the
    algorithm optimizes against) and delta (default the spec's)."""
    spec = as_spec(spec).validate()
    if spec.privacy.tau <= 0.0:
        raise ValueError(f"{what} requires tau > 0")
    mu_eff = mu if mu is not None else spec.weight_decay + 1.0 / spec.rho
    if mu_eff <= 0.0:
        raise ValueError("privacy accounting requires a strongly convex "
                         "local objective (mu > 0)")
    return spec, mu_eff, delta if delta is not None else spec.privacy.delta


def _dataset_sizes(local_dataset_size):
    """The per-agent ``q_i`` list of a sequence, or None for one q."""
    if isinstance(local_dataset_size, (str, bytes)):
        raise TypeError("local_dataset_size must be an int or a "
                        "sequence of per-agent ints, not a string")
    try:                     # a per-agent sequence of q_i?
        return [int(q) for q in local_dataset_size]
    except TypeError:        # one q (a Python or numpy int): every agent
        return None


def privacy_report(spec: Any, n_rounds: int,
                   local_dataset_size: Union[int, Sequence[int]],
                   delta: Optional[float] = None, *,
                   mu: Optional[float] = None):
    """Position a DP run on the paper's (eps, delta) map (Prop. 4 +
    Lemma 5 via :mod:`repro_torch.core.privacy`).

    Prop. 4 is a per-agent statement: eps_i depends on agent i's dataset
    size q_i, step size and local epochs.  ``local_dataset_size`` is one q
    (every agent) or a per-agent sequence; with per-agent sizes or a
    grouped spec (``agent_groups``) the report carries the per-agent
    ``(eps_i, delta)`` table (``report.per_agent``), each group's agents
    at its ``gamma`` and ``n_epochs``, and its headline ``adp_eps`` is the
    max over agents.  A homogeneous spec with one q gives the scalar
    report.  ``mu`` defaults to the curvature the algorithm optimizes
    against (weight_decay + 1/rho).  The runtime clips the per-agent mean
    gradient at C, so the per-sample-equivalent sensitivity is C * q_i;
    an unclipped run assumes 1.0."""
    from repro_torch.core.privacy import PrivacyReport

    spec, mu_eff, delta_eff = _accounting(spec, mu, delta, "privacy_report")
    p = spec.privacy
    qs = _dataset_sizes(local_dataset_size)
    if spec.agent_groups is None and qs is None:
        gamma = _resolve_gamma(spec, spec.gamma)
        sensitivity = (p.clip * local_dataset_size
                       if p.clip is not None else 1.0)
        return PrivacyReport.build(
            sensitivity=sensitivity, mu=mu_eff, tau=p.tau,
            q=local_dataset_size, gamma=gamma, K=n_rounds,
            n_epochs=spec.n_epochs, delta=delta_eff)
    qs, gammas, epochs, sensitivities = _per_agent_inputs(
        spec, qs, local_dataset_size)
    return PrivacyReport.build_per_agent(
        sensitivities=sensitivities, mu=mu_eff, tau=p.tau, qs=qs,
        gammas=gammas, K=n_rounds, n_epochs_seq=epochs, delta=delta_eff)


def _per_agent_inputs(spec: FedSpec, qs, local_dataset_size):
    """One accounting row per agent of a validated spec: ``(qs, gammas,
    epochs, sensitivities)``, each of length N (a group's agents at its
    step size and epochs)."""
    if spec.n_agents is None:
        raise ValueError("per-agent privacy_report needs a resolved "
                         "n_agents")
    N = spec.n_agents
    if qs is None:
        qs = [int(local_dataset_size)] * N
    if len(qs) != N:
        raise ValueError(f"local_dataset_size has {len(qs)} entries for "
                         f"n_agents={N}")
    groups = spec.resolved_groups()
    if groups is None:
        gammas = [_resolve_gamma(spec, spec.gamma)] * N
        epochs = [spec.n_epochs] * N
    else:
        gammas, epochs = [], []
        for g in groups:
            gammas.extend([_resolve_gamma(spec, g.gamma)] * g.size)
            epochs.extend([g.n_epochs] * g.size)
    clip = spec.privacy.clip
    sensitivities = [clip * q if clip is not None else 1.0 for q in qs]
    return qs, gammas, epochs, sensitivities


def effective_privacy_report(spec: Any, schedule, local_dataset_size,
                             delta: Optional[float] = None, *,
                             mu: Optional[float] = None):
    """Per-agent privacy report under a REALISED async arrival schedule
    (the reference's): ``schedule`` is the ``(n_rounds, n_agents)`` 0/1
    record of a bounded-staleness run (a broker's
    ``ArrivalSchedule.arrivals`` or the stacked ``arrivals`` rows).
    Agent i composes Prop. 4 over ``K_i = released_rounds_i`` rounds, the
    rounds of local work its increments carried
    (:func:`repro_torch.fed.async_engine.effective_counts`), instead of
    the nominal round count, at its group's ``gamma`` and ``n_epochs``:
    always the per-agent table.  ``local_dataset_size`` is one q or a
    per-agent sequence."""
    from repro_torch.core.privacy import PrivacyReport
    from repro_torch.fed.async_engine import effective_counts

    spec, mu_eff, delta_eff = _accounting(spec, mu, delta,
                                          "effective_privacy_report")
    qs, gammas, epochs, sensitivities = _per_agent_inputs(
        spec, _dataset_sizes(local_dataset_size), local_dataset_size)
    N = spec.n_agents
    sched = np.asarray(schedule)
    if sched.ndim != 2 or sched.shape[1] != N:
        raise ValueError(f"schedule must be (n_rounds, n_agents={N}), "
                         f"got shape {sched.shape}")
    arrivals, released = effective_counts(sched, spec.max_staleness)
    return PrivacyReport.build_per_agent(
        sensitivities=sensitivities, mu=mu_eff, tau=spec.privacy.tau, qs=qs,
        gammas=gammas, K=int(sched.shape[0]), n_epochs_seq=epochs,
        delta=delta_eff, Ks=[int(k) for k in released],
        arrivals=[int(a) for a in arrivals])


# ---------------------------------------------------------------------------
# The trainer handle
# ---------------------------------------------------------------------------

class FedTrainer:
    """Uniform handle over both Fed-PLT front ends (the reference's).

    ``init / step / run / consensus / privacy_report`` mean the same
    thing on the dense paper problems and at model scale; only ``step``
    / ``run`` arity differs (model-scale rounds consume a batch).  Where
    the reference takes a ``PRNGKey`` the port takes an integer seed."""

    spec: FedSpec

    def init(self, seed: int = 0, *args):
        raise NotImplementedError

    def step(self, state, *args, **kw):
        raise NotImplementedError

    def run(self, seed: int, n_rounds: int, *args, **kw):
        raise NotImplementedError

    def consensus(self, state):
        raise NotImplementedError

    def privacy_report(self, n_rounds: int, local_dataset_size=None,
                       delta: Optional[float] = None):
        raise NotImplementedError


class DenseTrainer(FedTrainer):
    """:class:`repro_torch.core.fedplt.FedPLT` behind the trainer handle
    (``init / step / run / consensus / privacy_report``), on ``device``
    (CUDA unless ``device='cpu'``; the problem's data is moved there).
    The curvature moduli come from the problem unless the spec sets them;
    a weight decay overrides ``prox_h`` with the weight-decay prox.  A
    sharded spec builds its mesh (``self.mesh``), as :class:`ModelTrainer`
    does; the state then holds this rank's block, while the draws, the
    criterion and the consensus are global."""

    def __init__(self, problem, spec: FedSpec, device=None):
        if spec.n_agents not in (None, problem.n_agents):
            raise ValueError(f"spec.n_agents={spec.n_agents} != "
                             f"problem.n_agents={problem.n_agents}")
        from repro_torch.core.fedplt import FedPLT

        self.device = resolve_device(device)
        self.spec = dataclasses.replace(spec, n_agents=problem.n_agents)
        # the spec with the problem's curvature filled in: validation and
        # privacy accounting both need the real moduli
        self._resolved = dataclasses.replace(
            self.spec,
            mu=spec.mu if spec.mu is not None
            else float(problem.strong_convexity()),
            L=spec.L if spec.L is not None
            else float(problem.smoothness())).validate()
        self.mesh = self.spec.build_mesh(self.device)
        if self.mesh is not None:
            from repro_torch.launch.mesh import mesh_device

            self.device = mesh_device(self.device)
        self.problem = problem.to(self.device)
        prox_override = (self.spec.resolve_prox_h()
                         if self.spec.weight_decay != 0.0 else None)
        groups = self._resolved.resolved_groups()
        solver_groups = None
        if groups is not None:
            solver_groups = tuple(
                (g.size, scfg) for g, scfg in zip(
                    groups, self._resolved.group_solver_configs()))
        part = self._resolved.participation_schedule()
        self.algo = FedPLT(self.problem, self.spec.to_dense_config(),
                           prox_h=prox_override,
                           solver_groups=solver_groups,
                           participation=part if isinstance(part, tuple)
                           else None, mesh=self.mesh)

    def init(self, seed: int = 0, x0=None):
        return self.algo.init(seed, x0)

    def step(self, state, u=None, batch_idx=None, noise=None):
        """One Fed-PLT round (``u``, ``batch_idx``, ``noise``: the
        round's draws, replayed when given)."""
        return self.algo.round(state, u, batch_idx, noise)

    def run(self, seed: int, n_rounds: int, **draws):
        """Run from a fresh init; returns ``(state, criterion_history)``."""
        return self.algo.run(seed, n_rounds, **draws)

    def run_recorded(self, seed: int, n_rounds: int, **draws):
        """:meth:`run` that also returns the realized ``(n_rounds, N)``
        participation (async: arrival) schedule (feed it to
        :meth:`effective_privacy_report` or :meth:`replay`)."""
        return self.algo.run_recorded(seed, n_rounds, **draws)

    def replay(self, seed: int, schedule, **draws):
        """Re-run a recorded arrival schedule (async rounds) from a fresh
        init; bit for bit the run that recorded it."""
        return self.algo.replay(seed, schedule, **draws)

    def round_with_faults(self, state, arrival=None, corrupt=None,
                          live=None, **draws):
        """One round under the broker's rows: ``arrival`` (an ``(N,)`` 0/1
        row, async rounds), ``corrupt`` (per-agent corruption multipliers,
        0 = clean) and ``live`` (0/1 survivor mask); returns ``(state,
        u)``.  All None reproduces :meth:`step`."""
        return self.algo.round_with_faults(state, arrival, corrupt, live,
                                           **draws)

    def consensus(self, state) -> torch.Tensor:
        return self.algo.x_bar(state)

    def save_state(self, path: str, state, extra: Optional[dict] = None):
        """Checkpoint ``state`` (:mod:`repro_torch.checkpoint`; the round
        counter ``k`` a 0-d int32 leaf, the manifest's step) with its
        generator's state in ``extra["generator"]``.  The reference's
        dense state keys its PRNG key as ``.key``, which this one has
        not: its draws come from the generator.  Under a mesh every rank
        calls this with its block: the file holds the global state (rank
        0 writes it; every rank's generator is in the same state)."""
        extra = dict(extra or {},
                     generator=ckpt.generator_state(state.generator))
        _save(self, path, state, step=state.k, extra=extra)

    def restore_state(self, path: str, like):
        """Restore a state saved by :meth:`save_state` into ``like`` (a
        state of this trainer, e.g. from :meth:`init`, whose generator
        takes the saved state; under a mesh this rank's block, which it
        keeps of the file's global state); returns ``(state, extra)``."""
        state = ckpt.restore_checkpoint(path, like, self.device,
                                        shardings=_own(self))
        return state, _restore_generator(path, state.generator)

    def _placement(self, key: str) -> dict:
        """How a leaf of the state (its checkpoint key) is split over the
        mesh: the coordinator row ``y`` by columns only, the ``(N,)``
        staleness counters by agent rows only, the rest (``y_tag`` as
        ``x``) by agent rows and columns."""
        if key == ".staleness":
            return dict(width=None)
        return dict(width=self.problem.dim, rows=key != ".y")

    def privacy_report(self, n_rounds: int, local_dataset_size=None,
                       delta: Optional[float] = None):
        """``local_dataset_size`` (one q or a per-agent sequence of q_i)
        defaults to the problem's q."""
        q = (local_dataset_size if local_dataset_size is not None
             else self.problem.q)
        return privacy_report(self._resolved, n_rounds, q, delta,
                              mu=self.algo.mu if self.algo.mu > 0 else None)

    def effective_privacy_report(self, schedule, local_dataset_size=None,
                                 delta: Optional[float] = None):
        """Per-agent report under a realised async arrival schedule
        (:func:`effective_privacy_report`; ``local_dataset_size`` defaults
        to the problem's q)."""
        q = (local_dataset_size if local_dataset_size is not None
             else self.problem.q)
        return effective_privacy_report(
            self._resolved, schedule, q, delta,
            mu=self.algo.mu if self.algo.mu > 0 else None)


class ModelTrainer(FedTrainer):
    """:mod:`repro_torch.fed.runtime` behind one handle: ``init / step /
    run / consensus / privacy_report``.  Runs on the model's device
    (CUDA unless ``device='cpu'``).  A sharded spec builds its mesh
    (``self.mesh``); the state then holds this rank's agent rows -- and,
    under a model axis, its column block of them -- on ``cuda:LOCAL_RANK``
    for a CUDA run (or the device given with its index), while ``step``
    takes the global batch and rows and the consensus averages over
    every rank."""

    def __init__(self, model, spec: FedSpec, device=None):
        if spec.n_agents is None:
            raise ValueError("FedSpec.n_agents is required at model scale")
        if spec.gamma is None:
            raise ValueError("FedSpec.gamma is required at model scale "
                             "(the local moduli are unknown)")
        from repro_torch.fed import runtime

        self.spec = spec.validate()
        self.model = model
        self.device = resolve_device(device)
        self.mesh = self.spec.build_mesh(self.device)
        if self.mesh is not None:
            from repro_torch.launch.mesh import mesh_device

            self.device = mesh_device(self.device)
        self._runtime = runtime
        self.packed_meta = (runtime.packed_layout(model, self.spec)
                            if self.spec.state_layout == "packed" else None)
        # each leaf's block in the tree layout under a model axis
        self.tree_blocks = runtime.tree_blocks(model, self.spec, self.mesh)
        self._step = runtime.make_train_step(model, self.spec, self.mesh)

    def init(self, seed: int = 0, params: Optional[dict] = None):
        """A fresh state; returns ``(state, generator)``, the generator
        (seeded on the run's device) drawing every later random choice."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = self._runtime.init_state(self.model, self.spec, self.device,
                                         gen, params, self.mesh)
        return state, gen

    @torch.no_grad()
    def step(self, state, batch, generator=None, u=None, noise=None,
             corrupt=None, live=None, arrival=None):
        """One Fed-PLT round on an agent-stacked batch (``u`` replays an
        ``(N,)`` participation row, ``noise(epoch, w)`` the DP draw).
        ``corrupt`` / ``live`` are fault rows: per-agent corruption
        (``(N,)`` multipliers or ``(N, 2)`` ``[mult, add]`` pairs, e.g. a
        :class:`repro_torch.fed.faults.FaultPlan` realised per round) and
        the ``(N,)`` survivor mask after evictions.  ``arrival`` (async
        rounds) replaces the arrival draw with an ``(N,)`` 0/1 row: a
        broker's row, or a recorded schedule's in a replay."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        return self._step(state, batch, generator=generator, u=u,
                          noise=noise, corrupt=corrupt, live=live,
                          arrival=arrival)

    def run(self, seed: int, n_rounds: int, batches):
        """Run from a fresh init; ``batches`` is a callable ``i -> batch``
        or an iterable.  Returns ``(state, metrics_history)``: scalar
        metrics as floats, the async rounds' ``arrivals`` row as a list."""
        state, gen = self.init(seed)
        it = None if callable(batches) else iter(batches)
        history = []
        for i in range(n_rounds):
            batch = batches(i) if it is None else next(it)
            state, m = self.step(state, batch, gen)
            history.append({k: float(v) if v.ndim == 0 else v.tolist()
                            for k, v in m.items()})
        return state, history

    def consensus(self, state) -> dict:
        return self._runtime.consensus_model(state, meta=self.packed_meta,
                                             mesh=self.mesh,
                                             n_agents=self.spec.n_agents,
                                             blocks=self.tree_blocks)

    def save_state(self, path: str, state, generator=None,
                   extra: Optional[dict] = None):
        """Checkpoint the round state (:mod:`repro_torch.checkpoint`, the
        reference's keys: ``.x``, ``.z``, ``.t`` and ``.step``, a 0-d int32
        leaf; a packed state in the reference's columns) at manifest step
        ``state.step``, with ``generator``'s state in
        ``extra["generator"]``.  Under a mesh every rank calls this with
        its block of the state: the blocks are gathered over the agent
        group (and a packed state's columns, or a tree's split leaves,
        over the model group), and
        rank 0 writes the file the unsharded run writes for the same
        state (every rank's generator is in the same state)."""
        extra = dict(extra or {})
        if generator is not None:
            extra["generator"] = ckpt.generator_state(generator)
        _save(self, path, state, step=state.step, extra=extra,
              packed_meta=self.packed_meta)

    def restore_state(self, path: str, like, generator=None):
        """Restore a round state into the restore target ``like`` (a
        state of this trainer, e.g. from :meth:`init`: under a mesh this
        rank's block, which it keeps of the file's global state) on the
        trainer's device; a saved generator state goes into
        ``generator``.  Returns ``(state, extra)``.  Reads the
        reference's checkpoints too, and any run's, sharded or not."""
        state = ckpt.restore_checkpoint(path, like, self.device,
                                        packed_meta=self.packed_meta,
                                        shardings=_own(self))
        return state, _restore_generator(path, generator)

    def _placement(self, key: str) -> dict:
        """How a leaf of the state (its checkpoint key) is split over the
        mesh: by agent rows, and a packed buffer (``y_tag`` as ``x``) by
        its columns too; a tree leaf under a model axis by its split dim
        (the ``(N,)`` staleness counters, and a tree without a model
        axis, split rows only)."""
        if key == ".staleness":
            return dict(width=None)
        if self.packed_meta is not None:
            return dict(width=self.packed_meta.width)
        if self.tree_blocks is None or "/" not in key:
            return dict(width=None)
        name = key.split("/", 1)[1].replace("/", ".")
        if not self.tree_blocks.split(name):
            return dict(width=None)
        return dict(width=self.tree_blocks.sizes[name],
                    axis=1 + self.tree_blocks.dims[name])

    def privacy_report(self, n_rounds: int, local_dataset_size=None,
                       delta: Optional[float] = None):
        """``local_dataset_size`` may be one int or a per-agent sequence
        of q_i."""
        if local_dataset_size is None:
            raise ValueError("model-scale privacy_report needs the local "
                             "dataset size q_i")
        return privacy_report(self.spec, n_rounds, local_dataset_size,
                              delta)


def build_trainer(problem_or_model, spec: Any, device=None) -> FedTrainer:
    """The front door: a :class:`DenseTrainer` for a dense problem
    (``local_loss`` + ``n_agents``), a :class:`ModelTrainer` for a model
    (``init`` + ``loss_fn``), on ``device`` (CUDA unless the CPU is asked
    for).  ``spec`` may be a :class:`FedSpec` or a config with
    ``.to_spec()``."""
    spec = as_spec(spec)
    if hasattr(problem_or_model, "local_loss") and \
            hasattr(problem_or_model, "n_agents"):
        return DenseTrainer(problem_or_model, spec, device)
    if hasattr(problem_or_model, "loss_fn") and \
            hasattr(problem_or_model, "init"):
        return ModelTrainer(problem_or_model, spec, device)
    raise TypeError(
        f"cannot build a trainer for {type(problem_or_model).__name__}: "
        f"expected a dense problem (local_loss/n_agents) or a model "
        f"(init/loss_fn)")


# ---------------------------------------------------------------------------
# CLI generation
# ---------------------------------------------------------------------------

def _cli_entries():
    out = []
    for owner, cls in (("spec", FedSpec), ("privacy", PrivacySpec),
                       ("compression", CompressionSpec)):
        for f in dataclasses.fields(cls):
            if f.name in ("privacy", "compression"):
                continue
            meta = f.metadata.get("cli")
            if meta is None or not meta["expose"]:
                continue
            flag = meta["flag"] or "--" + f.name.replace("_", "-")
            dest = flag.lstrip("-").replace("-", "_")
            default = (meta["default"] if meta["default"] is not None
                       else f.default)
            kwargs = dict(default=default, help=meta["help"])
            if f.type in ("bool", bool):
                kwargs["action"] = "store_true"
            else:
                kwargs["type"] = meta["type"] or type(default)
                if meta["choices"]:
                    kwargs["choices"] = meta["choices"]
            if f.name == "name" and owner == "compression":
                kwargs["choices"] = available_compressors()
            out.append((owner, f.name, flag, dest, kwargs))
    return out


def add_spec_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Add one flag per exposed :class:`FedSpec` field."""
    for _, _, flag, _, kwargs in _cli_entries():
        ap.add_argument(flag, **kwargs)
    return ap


def spec_from_args(args) -> FedSpec:
    """A :class:`FedSpec` from parsed args (or a raw argv list)."""
    if not isinstance(args, argparse.Namespace):
        ap = argparse.ArgumentParser(prog="fedspec")
        add_spec_args(ap)
        args = ap.parse_args(list(args))
    buckets = {"spec": {}, "privacy": {}, "compression": {}}
    for owner, name, _, dest, _ in _cli_entries():
        buckets[owner][name] = getattr(args, dest)
    return FedSpec(privacy=PrivacySpec(**buckets["privacy"]),
                   compression=CompressionSpec(**buckets["compression"]),
                   **buckets["spec"])
