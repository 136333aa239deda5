"""Fed-PLT at model scale (counterpart of ``repro/fed/runtime.py``).

The agents' states ``(x, z)`` are the model's parameters stacked on a
leading agent axis: a dict of ``(A, ...)`` tensors (tree layout) or ONE
resident ``(A, width)`` buffer per variable (packed layout).  One call
of the train step is one round of the paper's Algorithm 1 through
:mod:`repro_torch.fed.engine`.

The gradient oracle loops over agents (where JAX vmaps): agent ``i``'s
parameters are views of its state row, made autograd leaves with
``detach().requires_grad_()`` and passed through
``torch.func.functional_call``; ``torch.autograd.grad`` returns the
per-leaf gradients, which are copied into ONE preallocated gradient
buffer of the state's layout.  No parameter is copied on the way in.

Sharded rounds (a ``mesh``, :mod:`repro_torch.fed.sharding`): each rank
holds only its ``(N / shards, ...)`` row block of the state, takes its
agents of the global batch, and passes the global ``(N,)`` rows to the
engine; the metrics and the consensus are means over all N agents
(local sums, all-reduced, over N).  Every rank's generator is seeded
alike, so all ranks draw the same participation row; the DP noise is
drawn for all N agents in agent order on every rank, which keeps each
agent's own (:func:`repro_torch.core.solvers.draw_noise`), so agents on
different ranks never share noise and the draws are the unsharded run's.
An injected ``noise(epoch, w)`` is handed this rank's block.

Under a model axis (packed layout) the state is this rank's
``(N / shards, width / m)`` column block where ``m`` divides the width
(replicated columns otherwise).  The gradient oracle then takes each of
its agents in turn: it gathers the agent's row over the model group,
runs ``model.loss_fn`` on this rank's contiguous share ``b_r`` of the
agent's ``b`` batch rows (the loss is a mean over tokens), weights the
gradient by ``b_r / b``, sums it over the model group and keeps this
rank's columns; the loss metric is the same weighted sum.  So the model
axis divides both the state and the per-agent forward; a rank with an
empty share contributes zeros.  An MoE model couples an agent's batch
rows (its capacity and aux loss are over all the agent's tokens), so
there every model rank runs the whole batch and weights it by ``1 /
m``.  The clip norm and the noise are over
whole rows (:class:`repro_torch.core.solvers.StateBlock`).

Under a model axis in the tree layout each leaf of the state is this
rank's block by the leaf's spec (:func:`tree_blocks`,
:class:`repro_torch.fed.sharding.TreeBlocks`: the leaf's tensor-parallel
dim split over the model ranks, or the whole leaf), in the leaf's own
dtype.  The oracle works as in the packed layout, leaf by leaf: it
gathers each split leaf's full value for the agent's forward on this
rank's share of the batch rows, sums every leaf's weighted gradient over
the model group and keeps each leaf's block.  The clip norm sums the
split leaves' partial squares over the group (a replicated leaf counts
once) and each leaf's noise is drawn at its full shape and cut, so a
``1 x m`` run draws what the ``1 x 1`` run draws.

Heterogeneous agent groups (``spec.agent_groups``): each group gets its
own solver (its ``SolverConfig`` from ``spec.group_solver_configs()``,
its moduli from ``spec.moduli_for(gamma_g)``), whose gradient oracle
takes the group's rows of the batch and writes its rows of the one
gradient buffer; the engine runs the groups in order on their rows of the
state (:func:`repro_torch.fed.engine.run_solvers`).  The ``loss`` metric
is the mean of every group's last-epoch losses over the agents.  A
one-group spec builds the ungrouped round (no slicing), with the group's
knobs.  The draws of a round with two groups or more: an injected
``noise(epoch, w)`` still returns the epoch's draw for the whole state
(this rank's block), called once a group an epoch below the group's
``N_e`` with the group's iterate ``w``, and each group keeps its rows;
without it, when a group draws DP noise, the round first draws one seed
from the generator and group g draws from its own generator seeded with
``seed + g``, the noise of its agents in agent order, each rank keeping
its rows -- so every rank draws alike (each runs only its own groups),
no two agents share noise, and a sharded grouped run draws what the
unsharded one draws.  The participation row follows, as always.

Bounded-staleness async rounds (``async_mode="stale"``): the state also
carries ``y_tag`` (shaped like ``x``, this rank's block under a mesh) and
the ``(A,)`` int32 ``staleness`` counters, and the step dispatches to
:mod:`repro_torch.fed.async_engine`; ``arrival=`` replaces the arrival
draw with a given global row, and the metrics hold the realised global
``arrivals`` row and the mean ``staleness``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.solvers import StateBlock
from repro_torch.fed import compress as compress_lib
from repro_torch.fed import async_engine, engine, sharding
from repro_torch.fed.solvers import (make_local_solver,
                                     make_packed_local_solver)

tree_map = pytree.tree_map


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Thin legacy shim over :class:`repro_torch.fed.api.FedSpec` (the
    reference's, with the port's backend names: ``use_fused_update`` for
    ``use_pallas_update``, ``engine_backend`` / ``compress_backend``
    ``"torch" | "fused"`` for ``"xla" | "pallas"``).  Every entry point
    normalizes it via :meth:`to_spec` (``api.as_spec``); prefer a
    ``FedSpec`` in new code."""

    n_agents: int = 16
    rho: float = 1.0
    gamma: float = 0.05
    n_epochs: int = 5
    participation: float = 1.0
    tau: float = 0.0                 # DP noise std (forces noisy local GD)
    clip: Optional[float] = None     # per-agent gradient clipping
    weight_decay: float = 0.0        # coordinator prox: l2 regularizer h
    use_fused_update: bool = False   # fused fedplt_update kernel
    solver: str = "gd"               # gd | agd | sgd (tau>0 -> noisy_gd)
    # curvature moduli of the local losses; 0 -> derived from gamma
    mu: float = 0.0
    L: float = 0.0
    compression: str = "none"        # z-uplink compressor registry name
    compress_ratio: float = 0.25
    compress_backend: str = "torch"  # "auto" | "torch" per-leaf | "fused"
    engine_backend: str = "torch"    # round edges: "torch" | "fused"
    state_layout: str = "tree"       # "tree" | "packed" resident buffer
    damping: float = 1.0             # Krasnosel'skii relaxation
    async_mode: str = "off"          # "off" | "stale" bounded staleness
    max_staleness: int = 0           # K: forced arrival bound
    guard_increments: bool = False   # finite/norm screen on uplinks
    guard_norm_bound: float = float("inf")  # inf = finiteness-only screen
    aggregator: str = "mean"         # repro_torch.fed.robust registry name
    aggregator_param: float = 0.0    # trim count f / clip radius

    def to_spec(self):
        from repro_torch.fed.api import CompressionSpec, FedSpec, PrivacySpec

        return FedSpec(
            n_agents=self.n_agents, rho=self.rho,
            participation=self.participation, damping=self.damping,
            solver=self.solver, n_epochs=self.n_epochs, gamma=self.gamma,
            mu=self.mu if self.mu != 0.0 else None,
            L=self.L if self.L > 0.0 else None,
            weight_decay=self.weight_decay,
            privacy=PrivacySpec(tau=self.tau, clip=self.clip),
            compression=CompressionSpec(name=self.compression,
                                        ratio=self.compress_ratio,
                                        backend=self.compress_backend),
            engine_backend=self.engine_backend,
            state_layout=self.state_layout,
            use_fused_update=self.use_fused_update,
            async_mode=self.async_mode,
            max_staleness=self.max_staleness,
            guard_increments=self.guard_increments,
            guard_norm_bound=self.guard_norm_bound,
            aggregator=self.aggregator,
            aggregator_param=self.aggregator_param)


class FedState(NamedTuple):
    """Per-agent federated state: ``x``/``z`` are dicts of ``(A, ...)``
    tensors, or ``(A, width)`` buffers under the packed layout; ``t`` is
    the coordinator's lagged copy of ``z`` under a compressed exchange
    (None otherwise: at model scale it is one more state-sized buffer);
    ``y_tag`` and ``staleness`` are the async carriers (None when
    synchronous)."""

    x: Any
    z: Any
    step: int
    t: Any = None
    # bounded-staleness async rounds only (None when synchronous): the
    # per-agent pulled coordinator point and the (A,) int32 counters
    y_tag: Any = None
    staleness: Any = None


def _stacked_meta_tree(model, n_agents: int) -> dict:
    return {name: torch.empty((n_agents,) + shape, dtype=dtype,
                              device="meta")
            for name, (shape, dtype) in model.param_shapes().items()}


def packed_layout(model, spec) -> compress_lib.PackedMeta:
    """The static packed layout of a model's agent-stacked state (shape
    arithmetic over meta tensors; nothing is allocated)."""
    return compress_lib.packed_meta(_stacked_meta_tree(model, spec.n_agents))


def tree_blocks(model, spec, mesh) -> Optional[sharding.TreeBlocks]:
    """The tree layout's per-leaf placement on ``mesh``'s model axis
    (None for the packed layout, or without a model axis)."""
    if spec.state_layout == "packed":
        return None
    return sharding.tree_blocks(
        {n: s for n, (s, _) in model.param_shapes().items()}, mesh)


def init_state(model, spec, device, generator=None,
               params: Optional[dict] = None, mesh=None) -> FedState:
    """Every agent starts from the same parameters: ``params`` when
    given (e.g. converted from the reference), else ``model.init``.
    Under a ``mesh`` only this rank's ``N / shards`` agent rows are
    allocated, and of a packed state only this rank's columns (of a tree
    under a model axis, each leaf's block)."""
    if params is None:
        params = model.init(generator, device)
    params = {n: params[n].to(device) for n in model.param_shapes()}
    A = spec.n_agents // sharding.mesh_agent_shards(mesh)
    compressed = spec.compression.name != "none"
    if spec.state_layout == "packed":
        meta = packed_layout(model, spec)
        row = torch.zeros((meta.width,), dtype=meta.dtype, device=device)
        for dst, src in zip(
                pytree.tree_leaves(compress_lib.unpack_row(row, meta)),
                params.values()):
            dst.copy_(src)
        x = sharding.col_block(row, mesh).expand(A, -1).clone()
        state = FedState(x=x, z=x.clone(), step=0,
                         t=x.clone() if compressed else None)
    else:
        blocks = tree_blocks(model, spec, mesh)
        if blocks is not None:
            params = blocks.block_tree(params, lead=0)
        x = {n: p[None].expand((A,) + tuple(p.shape)).clone()
             for n, p in params.items()}
        state = FedState(x=x, z={n: l.clone() for n, l in x.items()}, step=0,
                         t={n: l.clone() for n, l in x.items()} if compressed
                         else None)
    if spec.staleness_config().enabled:
        state = state._replace(
            y_tag=async_engine.init_y_tag(state.x),
            staleness=async_engine.init_staleness(A, device))
    return state


def _gradient_oracle(model, batch: dict, g, meta=None, mesh=None,
                     blocks=None):
    """``fgrad(w, epoch) -> (g, losses)``: per-agent loss gradients at the
    stacked state ``w`` (packed buffer when ``meta`` is given, else a
    dict of ``(A, ...)`` tensors), written into ``g`` (same layout as
    ``w``) every epoch.  Under a ``mesh`` with a model axis ``w`` and
    ``g`` are this rank's column blocks (a tree's leaf ``blocks``) and
    each agent's gradient is split over the model ranks by batch rows
    (module docstring)."""
    names = list(model.param_shapes())
    split = sharding.model_shards(mesh) > 1

    def rows(w, i):
        if meta is not None:
            return pytree.tree_leaves(compress_lib.unpack_row(w[i], meta))
        return [w[n][i] for n in names]

    def agent_grad(leaves, batch_i, dst):
        """``dst`` <- the gradient of the agent's loss; returns the loss."""
        with torch.enable_grad():
            loss = model.loss_fn(dict(zip(names, leaves)), batch_i)
            grads = torch.autograd.grad(loss, leaves)
        for d, src in zip(dst, grads):
            d.copy_(src)
        return loss.detach()

    def fgrad(w, epoch):
        del epoch  # the local batch is fixed within a round
        A = batch["tokens"].shape[0]
        losses = torch.empty((A,), dtype=torch.float32,
                             device=batch["tokens"].device)
        if not split:
            for i in range(A):
                leaves = [p.detach().requires_grad_() for p in rows(w, i)]
                losses[i] = agent_grad(leaves, {k: b[i] for k, b in
                                                batch.items()}, rows(g, i))
            return g, losses
        b = batch["tokens"].shape[1]
        if model.config.n_experts:
            # an MoE couples an agent's batch rows (the capacity and the
            # aux loss are over all its tokens): every rank runs them all
            share, weight = slice(0, b), 1.0 / sharding.model_shards(mesh)
        else:
            share = sharding.batch_share(mesh, b)
            weight = (share.stop - share.start) / b
        for i in range(A):
            if meta is not None:
                full = [sharding.model_gather(w[i:i + 1], mesh, meta.width)]
            else:
                full = [blocks.gather(n, w[n][i:i + 1]) for n in names]
            g_full = [torch.zeros_like(f) for f in full]
            losses[i] = 0.0
            if weight > 0:
                if meta is not None:
                    leaves, dst = rows(full[0], 0), rows(g_full[0], 0)
                else:
                    leaves, dst = [f[0] for f in full], [d[0] for d in g_full]
                leaves = [p.detach().requires_grad_() for p in leaves]
                losses[i] = agent_grad(leaves, {k: v[i, share] for k, v in
                                                batch.items()},
                                       dst) * weight
                for d in g_full:
                    d.mul_(weight)
            for d in g_full:
                sharding.model_sum(d, mesh)
            if meta is not None:
                g[i].copy_(sharding.col_block(g_full[0][0], mesh, meta.width))
            else:
                for n, d in zip(names, g_full):
                    g[n][i].copy_(blocks.block(n, d)[0])
        return g, sharding.model_sum(losses, mesh)

    return fgrad


def _group_generators(generator, n_groups: int):
    """One generator a group, seeded ``seed + g`` from one seed drawn from
    ``generator`` (None without one: the groups then share torch's global
    generator)."""
    if generator is None:
        return [None] * n_groups
    seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device))
    return [torch.Generator(device=generator.device).manual_seed(seed + g)
            for g in range(n_groups)]


def make_train_step(model, spec, mesh=None):
    """Returns ``step(state, batch, *, generator=None, u=None,
    noise=None, corrupt=None, live=None, arrival=None) -> (state,
    metrics)``.  ``batch`` leaves carry a leading agent axis (tokens
    ``(A, b, S)``); ``u`` replays an ``(A,)`` participation row;
    ``noise(epoch, w)`` overrides the noisy_gd draw (with groups: module
    docstring); ``corrupt`` (``(A,)`` or ``(A, 2)``) and ``live``
    (``(A,)``) are fault rows (:func:`repro_torch.fed.engine.round_step`).
    Under async rounds ``arrival`` (or ``u``: the same row) replaces the
    arrival draw; a synchronous spec refuses ``arrival``.  Under a
    ``mesh`` the batch and the rows are global (all A agents) and the
    state is this rank's row block."""
    spec = spec.validate()
    rcfg = spec.round_config()
    prox_h = spec.resolve_prox_h()
    N = spec.n_agents
    meta = packed_layout(model, spec) if spec.state_layout == "packed" \
        else None
    # (size, SolverConfig) a group: the spec's one solver when ungrouped
    groups = spec.resolved_groups()
    if groups is None:
        groups = ((N, spec.solver_config()),)
    else:
        groups = tuple((g.size, c) for g, c in
                       zip(groups, spec.group_solver_configs()))
    noisy = any(c.name == "noisy_gd" for _, c in groups)
    block_rows = None if mesh is None else sharding.agent_rows(mesh, N)
    owned = engine.group_rows([size for size, _ in groups], N, block_rows)
    blocks = tree_blocks(model, spec, mesh)
    cols = None
    if meta is not None and mesh is not None and sharding.cols_split(
            mesh, meta.width):
        cols = dict(cols=sharding.model_cols(mesh, meta.width),
                    width=meta.width,
                    row_sum=lambda t: sharding.model_sum(t, mesh))
    elif blocks is not None:
        cols = dict(cuts=tuple(blocks.cut(n, s) for n, (s, _) in
                               model.param_shapes().items()),
                    row_sum=lambda t: sharding.model_sum(t, mesh))
    starts = [sum(size for size, _ in groups[:g]) for g in range(len(groups))]

    def block_of(g, agents):
        """Group ``g``'s ``StateBlock``: the agents this rank holds of the
        group's own rows, every one of which the group's draws cover in
        agent order (None unsharded)."""
        if mesh is None:
            return None
        lo = starts[g]
        return StateBlock(slice(agents.start - lo, agents.stop - lo),
                          groups[g][0], **(cols or {}))

    stale = rcfg.staleness.enabled

    def train_step(state: FedState, batch: dict, *, generator=None, u=None,
                   noise=None, corrupt=None, live=None, arrival=None):
        if arrival is not None and not stale:
            raise ValueError("arrival schedules require async_mode='stale' "
                             "(synchronous rounds draw participation "
                             "internally)")
        if arrival is not None and u is not None:
            raise ValueError("give the arrival row once (arrival= or u=)")
        batch = sharding.fed_batch_specs(batch, mesh, spec.n_agents)
        # padding columns of a packed gradient stay zero
        g = tree_map(torch.zeros_like, state.x)
        gens = [generator]
        if len(groups) > 1 and noisy and noise is None:
            gens = _group_generators(generator, len(groups))

        def solver_of(g_idx, local, agents):
            size, scfg = groups[g_idx]
            whole = len(groups) == 1
            fgrad = _gradient_oracle(
                model, batch if whole else {k: b[local] for k, b in
                                            batch.items()},
                g if whole else tree_map(lambda l: l[local], g), meta, mesh,
                blocks)
            noise_g = noise
            if noise is not None and not whole:
                noise_g = (lambda e, w, local=local: tree_map(
                    lambda l: l[local], noise(e, w)))
            mu, L = spec.moduli_for(scfg.step_size)
            kw = dict(use_fused=spec.use_fused_update, has_aux=True,
                      generator=gens[g_idx if len(gens) > 1 else 0],
                      noise=noise_g, block=block_of(g_idx, agents))
            if meta is not None:
                return make_packed_local_solver(scfg, fgrad, spec.rho, mu, L,
                                                meta=meta, **kw)
            return make_local_solver(scfg, fgrad, spec.rho, mu, L, **kw)

        if len(groups) == 1:
            solver = solver_of(0, slice(None), block_rows or slice(0, N))
        else:
            built = {g_idx: solver_of(g_idx, local, agents)
                     for g_idx, local, agents in owned}
            solver = tuple(
                engine.SolverGroup(size, built.get(
                    g_idx, engine.other_rank_solver))
                for g_idx, (size, _) in enumerate(groups))
        t = state.t if rcfg.compressed else state.z
        rows = dict(generator=generator, corrupt=corrupt, live=live,
                    mesh=mesh)
        if meta is not None:
            if stale:
                res = async_engine.packed_async_round_step(
                    rcfg, meta, state.x, state.z, t, state.y_tag,
                    state.staleness, solver, prox_h,
                    arrival=u if arrival is None else arrival, **rows)
            else:
                res = engine.packed_round_step(rcfg, meta, state.x, state.z,
                                               t, solver, prox_h, u=u, **rows)
        else:
            if stale:
                res = async_engine.async_round_step(
                    rcfg, state.x, state.z, t, state.y_tag, state.staleness,
                    solver, prox_h, arrival=u if arrival is None else arrival,
                    blocks=blocks, **rows)
            else:
                res = engine.round_step(rcfg, state.x, state.z, t, solver,
                                        prox_h, u=u, blocks=blocks, **rows)
        metrics = {
            "loss": _loss_metric(res.aux, len(groups), mesh, spec.n_agents,
                                 res.u.device),
            "participation": sharding.agent_mean(res.u, mesh,
                                                 spec.n_agents),
        }
        new = FedState(x=res.x, z=res.z, step=state.step + 1,
                       t=res.t if rcfg.compressed else None)
        if stale:
            # the realised global (A,) arrival row: stacked over rounds it
            # is the schedule effective_privacy_report composes over
            metrics["arrivals"] = sharding.agent_gather(res.u, mesh,
                                                        spec.n_agents)
            metrics["staleness"] = sharding.agent_mean(
                res.staleness.float(), mesh, spec.n_agents)
            new = new._replace(y_tag=res.y_tag, staleness=res.staleness)
        return new, metrics

    return train_step


def _loss_metric(aux, n_groups: int, mesh, n_agents: int,
                 device) -> torch.Tensor:
    """The mean of the agents' last-epoch losses: the solver's ``(N_e,
    A)`` stack, or with several groups the tuple of theirs (epochs may
    differ); a group whose solver reports no aux drops out of the mean
    (NaN when nobody reports).  Under a ``mesh`` the mean is over every
    rank's agents."""
    if n_groups == 1:
        if aux is None:
            return torch.tensor(float("nan"))
        return sharding.agent_mean(aux[-1], mesh, n_agents)
    lasts = [a[-1] for a in (aux or ()) if a is not None]
    if mesh is None:
        return (torch.mean(torch.cat(lasts)) if lasts
                else torch.tensor(float("nan")))
    tot = torch.zeros(2, device=device)
    if lasts:
        tot[0] = torch.cat(lasts).sum()
        tot[1] = float(sum(l.numel() for l in lasts))
    sharding.agent_sum(tot, mesh)
    return tot[0] / tot[1]


def consensus_model(state: FedState, meta=None, mesh=None,
                    n_agents: Optional[int] = None, blocks=None) -> dict:
    """The deployable model: the agent average of the local states
    (``meta`` required for a packed state).  Under a ``mesh`` the state
    is this rank's block of ``n_agents`` agents: the row sums are
    all-reduced over the agent axis and divided by N, and a column block
    (a tree's leaf ``blocks``) is gathered over the model axis, on every
    rank."""
    if mesh is None:
        x = state.x if meta is None else compress_lib.unpack_leaves(state.x,
                                                                    meta)
        return {n: torch.mean(l, dim=0) for n, l in x.items()}
    if meta is None:
        mean = {n: sharding.agent_sum(torch.sum(l, dim=0), mesh).div_(
            n_agents) for n, l in state.x.items()}
        return mean if blocks is None else blocks.gather_tree(mean, lead=0)
    mean = sharding.agent_sum(torch.sum(state.x, dim=0, keepdim=True),
                              mesh).div_(n_agents)
    mean = sharding.model_gather(mean, mesh, meta.width)
    return compress_lib.unpack_row(mean[0], meta)


def privacy_report(fcfg, n_rounds: int, local_dataset_size: int,
                   delta: float = 1e-5):
    """Position a DP training run on the paper's (eps, delta) map: a
    delegate to :func:`repro_torch.fed.api.privacy_report` (one
    accountant for both front ends), charging the curvature the algorithm
    optimizes against (weight_decay + 1/rho)."""
    from repro_torch.fed import api

    return api.privacy_report(api.as_spec(fcfg), n_rounds,
                              local_dataset_size, delta)
