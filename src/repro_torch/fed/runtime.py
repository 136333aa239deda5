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
empty share contributes zeros.  The clip norm and the noise are over
whole rows (:class:`repro_torch.core.solvers.StateBlock`).

Bounded-staleness async rounds (``async_mode="stale"``): the state also
carries ``y_tag`` (shaped like ``x``, this rank's block under a mesh) and
the ``(A,)`` int32 ``staleness`` counters, and the step dispatches to
:mod:`repro_torch.fed.async_engine`; ``arrival=`` replaces the arrival
draw with a given global row, and the metrics hold the realised global
``arrivals`` row and the mean ``staleness``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.solvers import StateBlock
from repro_torch.fed import compress as compress_lib
from repro_torch.fed import async_engine, engine, sharding
from repro_torch.fed.solvers import (make_local_solver,
                                     make_packed_local_solver)

tree_map = pytree.tree_map


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


def init_state(model, spec, device, generator=None,
               params: Optional[dict] = None, mesh=None) -> FedState:
    """Every agent starts from the same parameters: ``params`` when
    given (e.g. converted from the reference), else ``model.init``.
    Under a ``mesh`` only this rank's ``N / shards`` agent rows are
    allocated, and of a packed state only this rank's columns."""
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


def _gradient_oracle(model, batch: dict, g, meta=None, mesh=None):
    """``fgrad(w, epoch) -> (g, losses)``: per-agent loss gradients at the
    stacked state ``w`` (packed buffer when ``meta`` is given, else a
    dict of ``(A, ...)`` tensors), written into ``g`` (same layout as
    ``w``) every epoch.  Under a ``mesh`` with a model axis ``w`` and
    ``g`` are this rank's column blocks and each agent's gradient is
    split over the model ranks by batch rows (module docstring)."""
    names = list(model.param_shapes())
    split = meta is not None and sharding.model_shards(mesh) > 1

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
        share = sharding.batch_share(mesh, b)
        weight = (share.stop - share.start) / b
        for i in range(A):
            full = sharding.model_gather(w[i:i + 1], mesh, meta.width)
            g_full = torch.zeros_like(full)
            losses[i] = 0.0
            if weight > 0:
                leaves = [p.detach().requires_grad_() for p in
                          rows(full, 0)]
                losses[i] = agent_grad(leaves, {k: v[i, share] for k, v in
                                                batch.items()},
                                       rows(g_full, 0)) * weight
                g_full.mul_(weight)
            sharding.model_sum(g_full, mesh)
            g[i].copy_(sharding.col_block(g_full[0], mesh, meta.width))
        return g, sharding.model_sum(losses, mesh)

    return fgrad


def make_train_step(model, spec, mesh=None):
    """Returns ``step(state, batch, *, generator=None, u=None,
    noise=None, corrupt=None, live=None, arrival=None) -> (state,
    metrics)``.  ``batch`` leaves carry a leading agent axis (tokens
    ``(A, b, S)``); ``u`` replays an ``(A,)`` participation row;
    ``noise(epoch, w)`` overrides the noisy_gd draw; ``corrupt`` (``(A,)``
    or ``(A, 2)``) and ``live`` (``(A,)``) are fault rows
    (:func:`repro_torch.fed.engine.round_step`).  Under async rounds
    ``arrival`` (or ``u``: the same row) replaces the arrival draw; a
    synchronous spec refuses ``arrival``.  Under a ``mesh`` the batch and
    the rows are global (all A agents) and the state is this rank's row
    block."""
    spec = spec.validate()
    scfg = spec.solver_config()
    rcfg = spec.round_config()
    prox_h = spec.resolve_prox_h()
    mu, L = spec.moduli()
    meta = packed_layout(model, spec) if spec.state_layout == "packed" \
        else None
    # every rank draws all N agents' noise and keeps its block's
    block = None
    if mesh is not None:
        block = StateBlock(sharding.agent_rows(mesh, spec.n_agents),
                           spec.n_agents)
        if meta is not None and sharding.cols_split(mesh, meta.width):
            block = block._replace(
                cols=sharding.model_cols(mesh, meta.width), width=meta.width,
                row_sum=lambda t: sharding.model_sum(t, mesh))

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
        fgrad = _gradient_oracle(model, batch, g, meta, mesh)
        kw = dict(use_fused=spec.use_fused_update, has_aux=True,
                  generator=generator, noise=noise, block=block)
        t = state.t if rcfg.compressed else state.z
        rows = dict(generator=generator, corrupt=corrupt, live=live,
                    mesh=mesh)
        if meta is not None:
            solver = make_packed_local_solver(scfg, fgrad, spec.rho, mu, L,
                                              meta=meta, **kw)
            if stale:
                res = async_engine.packed_async_round_step(
                    rcfg, meta, state.x, state.z, t, state.y_tag,
                    state.staleness, solver, prox_h,
                    arrival=u if arrival is None else arrival, **rows)
            else:
                res = engine.packed_round_step(rcfg, meta, state.x, state.z,
                                               t, solver, prox_h, u=u, **rows)
        else:
            solver = make_local_solver(scfg, fgrad, spec.rho, mu, L, **kw)
            if stale:
                res = async_engine.async_round_step(
                    rcfg, state.x, state.z, t, state.y_tag, state.staleness,
                    solver, prox_h, arrival=u if arrival is None else arrival,
                    **rows)
            else:
                res = engine.round_step(rcfg, state.x, state.z, t, solver,
                                        prox_h, u=u, **rows)
        metrics = {
            "loss": (sharding.agent_mean(res.aux[-1], mesh, spec.n_agents)
                     if res.aux is not None
                     else torch.tensor(float("nan"))),
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


def consensus_model(state: FedState, meta=None, mesh=None,
                    n_agents: Optional[int] = None) -> dict:
    """The deployable model: the agent average of the local states
    (``meta`` required for a packed state).  Under a ``mesh`` the state
    is this rank's block of ``n_agents`` agents: the row sums are
    all-reduced over the agent axis and divided by N, and a column block
    is gathered over the model axis, on every rank."""
    if mesh is None:
        x = state.x if meta is None else compress_lib.unpack_leaves(state.x,
                                                                    meta)
        return {n: torch.mean(l, dim=0) for n, l in x.items()}
    if meta is None:
        return {n: sharding.agent_sum(torch.sum(l, dim=0), mesh).div_(
            n_agents) for n, l in state.x.items()}
    mean = sharding.agent_sum(torch.sum(state.x, dim=0, keepdim=True),
                              mesh).div_(n_agents)
    mean = sharding.model_gather(mean, mesh, meta.width)
    return compress_lib.unpack_row(mean[0], meta)
