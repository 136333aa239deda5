"""Fed-PLT -- Algorithm 1 of the paper, batched over agents (counterpart of
``repro/core/fedplt.py``).

The paper-faithful dense front end: the local states are one ``(N, n)``
tensor, the single-leaf case of the round engine in
:mod:`repro_torch.fed.engine`, which owns the round topology (coordinator
prox -> reflection -> warm-started local solver -> Bernoulli participation
-> optional compressed z-exchange).  This class supplies the per-agent
gradient oracles and curvature moduli, and the loop over rounds that
records the paper's convergence criterion.

As in the reference, the local solver never takes the fused update
kernel here (its step size is a per-agent tensor): ``fedplt_update``
launches 0 times on the dense path.  Under ``engine_backend="fused"`` the
round edges, and under a compressed exchange with the fused compress
backend the compressor, run their kernels; so does ``sort_aggregate``
under an order-statistic aggregator.

The reference's ``lax.scan`` over rounds is a Python loop: the criterion
of every round stays on the device (one host sync when the caller reads
the history).  The random draws are explicit, as the port's parity rules
say: ``init`` takes an optional ``x0``; a round takes an optional
participation row ``u`` ``(N,)``, sgd minibatch indices ``batch_idx``
``(N_e, N, batch)`` and standard-normal noise ``noise`` ``(N_e, N, n)``
(scaled here by ``sqrt(2 gamma) tau``); ``run`` takes them stacked over
rounds.  What is not given is drawn from the state's ``torch.Generator``.

Heterogeneous agent groups (``solver_groups``, the reference's): each
contiguous group runs its own ``SolverConfig`` on its rows, with its
slice of the per-agent moduli (its step size and noise scale resolved
from them in float32), and ``participation`` may give every agent its
own rate.  The draws keep their global shapes with ``N_e`` the largest
epoch count of the groups: ``batch_idx`` ``(N_e, N, batch)`` (drawn when
a group is sgd) and ``noise`` ``(N_e, N, n)`` (when a group is noisy_gd),
and group g reads its own rows of its first ``N_e_g`` epochs.  A
homogeneous config draws exactly as without groups.

Under a ``mesh`` (the reference's ``FedPLT(mesh=)``; one process per
rank, :mod:`repro_torch.launch.mesh`) the dense ``(N, n)`` state follows
the engine's row and column rules (:mod:`repro_torch.fed.sharding`): each
rank holds its agents' rows and, where the model extent divides ``n``
(Table 5's n 100 over 2), its columns -- at the paper's n 5 the columns
are replicated.  The gradients use this rank's agents' ``A_i``, ``b_i``
and moduli; the oracle gathers ``w``'s rows over the model group (at
most a few hundred numbers) and keeps its columns of the closed-form
gradient.  The draws stay global: the participation row, the sgd
``batch_idx`` and the noise are drawn (or given) for all N agents and
sliced per rank, so a sharded run takes the unsharded run's draws.  The
criterion ``|| sum_i grad f_i(x_bar) ||^2`` and ``x_bar`` come from the
consensus all-reduced over the agent group and gathered over the model
group, on every rank.  The state's ``x``, ``z``, ``t`` and ``y`` are this
rank's block.  The dense state is a single leaf, so both layouts hold
the same ``(N, n)`` tensor; under a model axis the tree layout's rounds
run as the packed layout's (the guard's row norms, the compressor's rows
and a non-elementwise prox's row reach over the model group there).

Bounded-staleness async rounds (``async_mode="stale"``): the state
carries ``y_tag`` and the ``(N,)`` int32 ``staleness`` counters (this
rank's block under a mesh) and a round runs
:mod:`repro_torch.fed.async_engine`; ``arrival`` (or ``u``) replaces the
arrival draw with a given row, :meth:`FedPLT.run_recorded` returns the
realised schedule and :meth:`FedPLT.replay` re-runs one bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import prox as prox_lib
from repro_torch.core.solvers import SolverConfig, StateBlock
from repro_torch.fed import api
from repro_torch.fed import compress as compress_lib
from repro_torch.fed import async_engine, engine, sharding
from repro_torch.fed import solvers as solver_registry


class FedPLTState(NamedTuple):
    # under a mesh each of x, z, y and t is this rank's block
    x: torch.Tensor                 # (N, n) local models
    z: torch.Tensor                 # (N, n) auxiliary (PRS) variables
    y: torch.Tensor                 # (n,) coordinator model (last broadcast)
    generator: torch.Generator      # every draw not given explicitly
    k: int                          # round counter
    # the coordinator's copy of each z_i, only when the exchange is
    # compressed (advanced in place by the next round)
    t: Optional[torch.Tensor] = None
    # bounded-staleness async rounds only (None when synchronous): the
    # per-agent pulled coordinator point (updated in place by the next
    # round) and the staleness counters
    y_tag: Optional[torch.Tensor] = None        # (N, n)
    staleness: Optional[torch.Tensor] = None    # (N,) int32


@dataclasses.dataclass(frozen=True)
class FedPLTConfig:
    rho: float = 1.0
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    participation: float = 1.0        # p (uniform across agents)
    prox_h: str = "zero"              # coordinator regularizer
    batch_size: Optional[int] = None  # for the sgd oracle
    # curvature moduli of the f_i; None -> taken from the problem
    mu: Optional[float] = None
    L: Optional[float] = None
    dp_init: bool = False             # x0 ~ N(0, 2 tau^2/mu I)  (Prop. 4)
    # Remark 1 (uncoordinated solvers): per-agent step sizes tuned to the
    # LOCAL moduli (mu_i, L_i) instead of the global (min mu_i, max L_i)
    uncoordinated: bool = False
    compression: str = "none"         # compressor registry name
    compress_ratio: float = 0.25
    compress_energy: float = 0.95
    compress_backend: str = "torch"   # "auto" | "torch" | "fused"
    engine_backend: str = "torch"     # round edges: "torch" | "fused"
    state_layout: str = "tree"        # "tree" | "packed"
    damping: float = 1.0              # Krasnosel'skii relaxation
    async_mode: str = "off"
    max_staleness: int = 0
    guard_increments: bool = False
    guard_norm_bound: float = float("inf")
    aggregator: str = "mean"
    aggregator_param: float = 0.0

    def to_spec(self, n_agents: Optional[int] = None):
        """The equivalent :class:`repro_torch.fed.api.FedSpec`."""
        s = self.solver
        # tau is read only under noisy_gd (as in the reference)
        tau = s.tau if s.name == "noisy_gd" else 0.0
        return api.FedSpec(
            n_agents=n_agents, rho=self.rho,
            participation=self.participation, damping=self.damping,
            solver=s.name, n_epochs=s.n_epochs, gamma=s.step_size,
            mu=self.mu, L=self.L, batch_size=self.batch_size,
            uncoordinated=self.uncoordinated, prox_h=self.prox_h,
            privacy=api.PrivacySpec(tau=tau, clip=s.clip,
                                    dp_init=self.dp_init),
            compression=api.CompressionSpec(
                name=self.compression, ratio=self.compress_ratio,
                energy=self.compress_energy,
                backend=self.compress_backend),
            engine_backend=self.engine_backend,
            state_layout=self.state_layout,
            async_mode=self.async_mode,
            max_staleness=self.max_staleness,
            guard_increments=self.guard_increments,
            guard_norm_bound=self.guard_norm_bound,
            aggregator=self.aggregator,
            aggregator_param=self.aggregator_param)


def _row(draws, r):
    return None if draws is None else draws[r]


class FedPLT:
    """Paper-faithful Fed-PLT on a batched federated problem, on the
    problem's device.

    ``prox_h`` overrides the coordinator regularizer resolved from
    ``config.prox_h`` (the front door's weight-decay shorthand).
    ``solver_groups`` partitions the agent axis into ``(size,
    SolverConfig)`` groups (sizes summing to ``n_agents``; None: one group
    of ``config.solver``) and ``participation`` overrides
    ``config.participation`` with a per-agent ``(N,)`` tuple of rates
    (module docstring).  ``mesh`` shards the rounds."""

    def __init__(self, problem, config: FedPLTConfig, prox_h=None,
                 solver_groups=None, participation=None, mesh=None):
        if solver_groups is None:
            solver_groups = ((problem.n_agents, config.solver),)
        self._groups = tuple((int(size), scfg)
                             for size, scfg in solver_groups)
        sizes = [size for size, _ in self._groups]
        if sum(sizes) != problem.n_agents:
            raise ValueError(
                f"solver_groups sizes sum to {sum(sizes)}, problem "
                f"has n_agents={problem.n_agents}")
        self.problem = problem
        self.mesh = mesh
        self.cfg = config
        self.device = problem.device
        self.mu = (config.mu if config.mu is not None
                   else problem.strong_convexity())
        self.L = config.L if config.L is not None else problem.smoothness()
        if self.mu <= 0:  # nonconvex / merely convex: the 1/rho curvature
            self.mu = 0.0
        N, n = problem.n_agents, problem.dim
        if config.uncoordinated and hasattr(problem, "per_agent_smoothness"):
            mu_i = problem.per_agent_strong_convexity()
            L_i = problem.per_agent_smoothness()
        else:
            mu_i = torch.full((N,), self.mu)
            L_i = torch.full((N,), self.L)
        # this rank's block of the (N, n) state, and its agents' data
        self._rows, self._cols, self._block = slice(0, N), slice(0, n), None
        self.local = problem
        if mesh is not None:
            self._rows = sharding.agent_rows(mesh, N)
            self._cols = sharding.model_cols(mesh, n)
            self._block = StateBlock(self._rows, N)
            if sharding.cols_split(mesh, n):
                self._block = self._block._replace(
                    cols=self._cols, width=n,
                    row_sum=lambda t: sharding.model_sum(t, mesh))
            self.local = problem.agent_block(self._rows)
        # float32 (N, 1) columns: the step size is computed from them in
        # float32, as the reference computes it from its vmapped moduli
        self.mu_i = mu_i.to(self.device, torch.float32).reshape(
            N, 1)[self._rows]
        self.L_i = L_i.to(self.device, torch.float32).reshape(
            N, 1)[self._rows]
        self.prox_h = (prox_h if prox_h is not None
                       else prox_lib.make_prox(config.prox_h))
        self._ecfg = config.to_spec(N).round_config()
        if participation is not None:
            self._ecfg = dataclasses.replace(
                self._ecfg, participation=tuple(participation))
        # packed layout: the dense state is single-leaf, so its resident
        # (N, n) buffer IS the stacked tensor; the tree layout under a
        # model axis takes the packed round, which reaches over the model
        # group where a round couples columns
        packed = (config.state_layout == "packed"
                  or sharding.model_shards(mesh) > 1)
        self._meta = (compress_lib.packed_meta(
            torch.empty((N, n), device="meta")) if packed else None)
        # this rank's part of each group: (g, local rows, global agents)
        self._owned = engine.group_rows(
            sizes, N, None if mesh is None else self._rows)
        # noisy_gd's sqrt(2 gamma) tau in float32 a group: per agent when
        # the step size is resolved from the moduli, else one value
        self._noise_scale = {}
        for g, local, _ in self._owned:
            scfg = self._groups[g][1]
            gamma = scfg.resolve_step_size(
                self.mu_i[local] + 1.0 / config.rho,
                self.L_i[local] + 1.0 / config.rho)
            self._noise_scale[g] = torch.sqrt(torch.as_tensor(
                2.0 * gamma, dtype=torch.float32)).to(self.device) * scfg.tau

    # ------------------------------------------------------------------
    def _own(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global ``(..., N, n)`` draw."""
        return a[..., self._rows, self._cols]

    def init(self, seed: int = 0, x0=None) -> FedPLTState:
        """A fresh state: ``x = z = x0`` (zeros, or under ``dp_init`` a
        draw of ``N(0, 2 tau^2 / mu)``, unless ``x0`` is given) and a
        generator seeded with ``seed`` on the problem's device.  ``x0``
        and the draw are global ``(N, n)``; a sharded state keeps its
        block."""
        N, n = self.problem.n_agents, self.problem.dim
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tau = self.cfg.solver.tau
        if x0 is not None:
            x0 = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        elif self.cfg.dp_init and tau > 0 and self.mu > 0:
            std = torch.sqrt(torch.tensor(2.0 * tau ** 2 / self.mu))
            x0 = std.to(self.device) * torch.randn(
                (N, n), generator=gen, device=self.device)
        else:
            x0 = torch.zeros((N, n), device=self.device)
        x0 = self._own(x0).contiguous()
        stale = self._ecfg.staleness.enabled
        return FedPLTState(x=x0, z=x0.clone(),
                           y=torch.zeros(x0.shape[1], device=self.device),
                           generator=gen, k=0,
                           t=x0.clone() if self._ecfg.compressed else None,
                           y_tag=(async_engine.init_y_tag(x0) if stale
                                  else None),
                           staleness=(async_engine.init_staleness(
                               x0.shape[0], self.device) if stale
                               else None))

    # ------------------------------------------------------------------
    def _solver(self, gen, batch_idx, noise):
        """The round's engine solver ``(x, v) -> (w, None)`` -- with
        several groups a tuple of :class:`repro_torch.fed.engine.SolverGroup`
        -- with its draws: sgd minibatch rows ``(N_e, N, batch)`` and
        noisy_gd noise ``(N_e, N, n)``, given or drawn from ``gen`` (global,
        ``N_e`` the groups' largest; a sharded round and a group take their
        rows)."""
        N, n, dev = self.problem.n_agents, self.problem.dim, self.device
        n_epochs = max(scfg.n_epochs for _, scfg in self._groups)
        names = {scfg.name for _, scfg in self._groups}
        idx = None
        if "sgd" in names and self.cfg.batch_size is not None:
            if batch_idx is None:
                batch_idx = torch.randint(
                    0, self.problem.q, (n_epochs, N, self.cfg.batch_size),
                    generator=gen, device=dev)
            idx = torch.as_tensor(batch_idx).to(dev)[:, self._rows]
        if "noisy_gd" in names:
            if noise is None:
                noise = torch.randn((n_epochs, N, n), generator=gen,
                                    device=dev)
            noise = self._own(torch.as_tensor(noise, dtype=torch.float32)
                              .to(dev))
        whole = len(self._groups) == 1
        built = {g: self._group_solver(g, local, agents, gen, idx, noise,
                                       whole)
                 for g, local, agents in self._owned}
        if whole:
            return built[0]
        return tuple(
            engine.SolverGroup(size, built.get(g, engine.other_rank_solver))
            for g, (size, _) in enumerate(self._groups))

    def _group_solver(self, g, local, agents, gen, idx, noise, whole):
        """Group ``g``'s solver on this rank's rows ``local`` of it (the
        global ``agents``); ``whole``: the one group of every agent, which
        slices nothing."""
        scfg = self._groups[g][1]
        mesh, cols, n = self.mesh, self._cols, self.problem.dim
        data = self.local if whole else self.local.agent_block(local)

        def full_rows(w):
            return w if mesh is None else sharding.model_gather(w, mesh, n)
        if scfg.name == "sgd" and self.cfg.batch_size is not None:
            rows_idx = idx if whole else idx[:, local]

            def fgrad(w, epoch):
                return data.minibatch_grads(full_rows(w),
                                            rows_idx[epoch])[:, cols]
        else:
            def fgrad(w, epoch):
                return data.grads(full_rows(w))[:, cols]

        if scfg.name not in solver_registry.CORE_SOLVERS:
            block = self._block
            if block is not None and not whole:
                lo = sum(size for size, _ in self._groups[:g])
                block = block._replace(
                    rows=slice(agents.start - lo, agents.stop - lo),
                    n_rows=self._groups[g][0])
            return solver_registry.make_local_solver(
                scfg, fgrad, self.cfg.rho, self.mu, self.L, generator=gen,
                block=block)
        noise_fn = None
        if scfg.name == "noisy_gd":
            scale = self._noise_scale[g]
            rows_noise = noise if whole else noise[:, local]

            def noise_fn(epoch, w):
                return scale * rows_noise[epoch]
        return solver_registry.make_local_solver(
            scfg, fgrad, self.cfg.rho, self.mu_i[local], self.L_i[local],
            generator=gen, noise=noise_fn, block=self._block)

    def _round_core(self, state: FedPLTState, u=None, batch_idx=None,
                    noise=None, corrupt=None, live=None, arrival=None):
        """One round; returns ``(next_state, u)`` with ``u`` the round's
        realized global ``(N,)`` participation (async: arrival) row.
        ``corrupt`` / ``live`` are fault rows (see
        :func:`repro_torch.fed.engine.round_step`); ``arrival`` (async
        rounds; ``u`` is the same row) replaces the arrival draw."""
        gen = state.generator
        solver = self._solver(gen, batch_idx, noise)
        compressed = self._ecfg.compressed
        t = state.t if compressed else state.z
        if arrival is not None and u is not None:
            raise ValueError("give the arrival row once (arrival= or u=)")
        if self._ecfg.staleness.enabled:
            rows = dict(generator=gen, corrupt=corrupt, live=live,
                        mesh=self.mesh,
                        arrival=u if arrival is None else arrival)
            if self._meta is not None:
                res = async_engine.packed_async_round_step(
                    self._ecfg, self._meta, state.x, state.z, t, state.y_tag,
                    state.staleness, solver, self.prox_h, **rows)
                y = res.y.reshape(-1)
            else:
                res = async_engine.async_round_step(
                    self._ecfg, state.x, state.z, t, state.y_tag,
                    state.staleness, solver, self.prox_h, **rows)
                y = res.y
            u = sharding.agent_gather(res.u, self.mesh,
                                      self.problem.n_agents)
            return FedPLTState(x=res.x, z=res.z, y=y, generator=gen,
                               k=state.k + 1,
                               t=res.t if compressed else None,
                               y_tag=res.y_tag,
                               staleness=res.staleness), u
        if arrival is not None:
            raise ValueError("arrival schedules require async_mode='stale' "
                             "(synchronous rounds draw participation "
                             "internally)")
        if self._meta is not None:
            res = engine.packed_round_step(
                self._ecfg, self._meta, state.x, state.z, t, solver,
                prox_h=self.prox_h, generator=gen, u=u, corrupt=corrupt,
                live=live, mesh=self.mesh)
            y = res.y.reshape(-1)   # (1, n) coordinator buffer -> (n,)
        else:
            res = engine.round_step(self._ecfg, state.x, state.z, t, solver,
                                    prox_h=self.prox_h, generator=gen, u=u,
                                    corrupt=corrupt, live=live,
                                    mesh=self.mesh)
            y = res.y
        u = sharding.agent_gather(res.u, self.mesh, self.problem.n_agents)
        return FedPLTState(x=res.x, z=res.z, y=y, generator=gen,
                           k=state.k + 1,
                           t=res.t if compressed else None), u

    # ------------------------------------------------------------------
    @torch.no_grad()
    def round(self, state: FedPLTState, u=None, batch_idx=None,
              noise=None) -> FedPLTState:
        """One round (a compressed exchange advances ``state.t`` in
        place)."""
        return self._round_core(state, u, batch_idx, noise)[0]

    @torch.no_grad()
    def round_with_arrival(self, state: FedPLTState, arrival=None, *,
                           batch_idx=None, noise=None):
        """One round returning ``(next_state, u)``; ``arrival`` (async
        rounds) replaces the arrival draw with a recorded ``(N,)`` 0/1 row
        -- the broker's numerics entry point."""
        return self._round_core(state, batch_idx=batch_idx, noise=noise,
                                arrival=arrival)

    @torch.no_grad()
    def round_with_faults(self, state: FedPLTState, arrival=None,
                          corrupt=None, live=None, *, u=None,
                          batch_idx=None, noise=None):
        """One round returning ``(next_state, u)`` (``u`` the global
        participation or arrival row) under the broker's rows:
        ``arrival`` (a recorded schedule row, async rounds), ``corrupt``
        (per-agent corruption multipliers or ``[mult, add]`` pairs applied
        to the solver output) and ``live`` (0/1 survivor mask); e.g.
        ``lambda s, u, c, l: algo.round_with_faults(s, u, c, l)[0]``.  All
        None reproduces :meth:`round`."""
        return self._round_core(state, u, batch_idx, noise, corrupt, live,
                                arrival)

    def run(self, seed: int, n_rounds: int, **draws):
        """Run ``n_rounds`` rounds from :meth:`init`; returns
        ``(final_state, criterion_history)``, ``criterion_history[k] =
        || sum_i grad f_i(x_bar_k) ||^2`` after round k (a tensor on the
        problem's device).  ``draws``: see :meth:`run_recorded`."""
        state, crit, _ = self.run_recorded(seed, n_rounds, **draws)
        return state, crit

    @torch.no_grad()
    def run_recorded(self, seed: int, n_rounds: int, *, u=None,
                     batch_idx=None, noise=None, x0=None):
        """:meth:`run` that also returns the realized ``(n_rounds, N)``
        participation (async: arrival) schedule -- feed it to
        :func:`repro_torch.fed.api.effective_privacy_report` or replay it
        with :meth:`replay`.  ``u`` ``(n_rounds, N)``, ``batch_idx``
        ``(n_rounds, N_e, N, batch)`` and ``noise`` ``(n_rounds, N_e, N,
        n)`` replay given draws round by round; ``x0`` the initial
        models."""
        state = self.init(seed, x0)
        N = self.problem.n_agents
        crit = torch.empty(n_rounds, device=self.device)
        sched = torch.empty((n_rounds, N), device=self.device)
        for r in range(n_rounds):
            state, ur = self._round_core(state, _row(u, r),
                                         _row(batch_idx, r), _row(noise, r))
            crit[r] = self.criterion(state)
            sched[r] = ur
        return state, crit, sched

    @torch.no_grad()
    def replay(self, seed: int, schedule, *, batch_idx=None, noise=None,
               x0=None):
        """Re-run a recorded ``(n_rounds, N)`` arrival schedule (async
        rounds) from :meth:`init`; returns ``(final_state,
        criterion_history)``, bit for bit the run that recorded it from
        the same ``seed`` and draws.  Each round still draws (and drops)
        the participation row that the recording drew, so the solvers'
        later draws from the generator are the recording's too."""
        if not self._ecfg.staleness.enabled:
            raise ValueError("replay requires async_mode='stale'")
        sched = torch.as_tensor(schedule, dtype=torch.float32)
        state = self.init(seed, x0)
        crit = torch.empty(sched.shape[0], device=self.device)
        for r in range(sched.shape[0]):
            state, _ = self._round_core(state, batch_idx=_row(batch_idx, r),
                                        noise=_row(noise, r),
                                        arrival=sched[r])
            engine.participation_mask(self._ecfg, self.device,
                                      state.generator)
            crit[r] = self.criterion(state)
        return state, crit

    # convenience -------------------------------------------------------
    def x_bar(self, state: FedPLTState) -> torch.Tensor:
        """The consensus ``mean_i x_i``, ``(n,)`` on every rank."""
        if self.mesh is None:
            return torch.mean(state.x, dim=0)
        s = sharding.agent_sum(torch.sum(state.x, dim=0, keepdim=True),
                               self.mesh).div_(self.problem.n_agents)
        return sharding.model_gather(s, self.mesh, self.problem.dim)[0]

    def criterion(self, state: FedPLTState) -> torch.Tensor:
        """The paper's ``|| sum_i grad f_i(x_bar) ||^2`` (a 0-d tensor on
        the problem's device): under a mesh each rank sums its agents'
        gradients at the consensus and the sums are all-reduced."""
        if self.mesh is None:
            return self.problem.criterion(state.x)
        g = torch.sum(self.local.grads(self.x_bar(state)), dim=0)
        return torch.sum(sharding.agent_sum(g, self.mesh) ** 2)
