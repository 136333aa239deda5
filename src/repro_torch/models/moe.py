"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``):
qwen2-moe (60 routed experts, top-4, 4 shared) and grok-1 (8 routed,
top-2).

The reference's capacity-buffer dispatch, with its numbers:

    token -> top-K experts -> rank within its expert -> (E, C, d) buffer
    (a contribution ranked C or later is dropped: it counts zero)

* Router: ``x.float() @ router`` in float32, a softmax, the top K by a
  stable descending sort (``jax.lax.top_k`` puts the lower expert first
  among equal probabilities, ``torch.topk`` promises no order), the K
  gates renormalised.  Aux loss ``E * sum(me * ce)``, ``ce`` from the
  one-hot counts (no gradient).
* Capacity ``C = int(cf * T * K / E) + 1`` over the T tokens of the flat
  route; ``int(cf * S * K / E) + 1`` a batch row on the grouped route
  (``cfg.moe_grouped and S > 1``).  A contribution's rank within its
  expert is the position of its (token, k) among that expert's in a
  stable argsort of the flat expert ids; ``slot = min(rank, C)``.  The
  reference's spill slot C computes a zero row, so the port leaves it out.
* Experts: the gated MLP batched over E (``torch.matmul`` on ``(E, rows,
  d)``; the reference computes it in XLA, outside any Pallas kernel).
* Combine: ``gate * gathered`` cast to x's dtype and the K contributions
  of each token summed over k in order, which is the reference's scatter
  into zeros (its ``flat_token`` is ``repeat(arange(T), K)``); then the
  shared experts' MLP.

Dispatch and combine are gathers with unique indices (:class:`_Rows`), and
so are their backwards: no two values go into one address, forward or
backward, so the layer adds nothing through atomics on the card and a
round repeats bit for bit (``index_add_``, ``index_put_`` with
``accumulate`` and autograd's backward of fancy indexing add through
atomics on CUDA).  The GSPMD-only fields (``moe_buffer_shard``,
``shard_residual``, ``activation_batch_axes``) change no number and are
left out.  ``torch.profiler`` sees the parts as the ranges ``moe.router``,
``moe.dispatch``, ``moe.experts``, ``moe.combine`` and ``moe.shared``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import init_mlp, mlp, mlp_shapes


def moe_shapes(cfg, dtype) -> dict:
    """``{leaf: (shape, dtype)}`` of one layer's MoE, nested as the
    reference's tree: ``router`` (always float32), ``experts`` (stacked
    over E) and, with shared experts, ``shared``."""
    d, E = cfg.d_model, cfg.n_experts
    shapes = {"router": ((d, E), torch.float32),
              "experts": {k: ((E,) + s, dtype) for k, s in mlp_shapes(
                  d, cfg.moe_d_ff, cfg.activation).items()}}
    if cfg.n_shared_experts:
        shapes["shared"] = {k: (s, dtype) for k, s in mlp_shapes(
            d, cfg.n_shared_experts * cfg.moe_d_ff, cfg.activation).items()}
    return shapes


def init_moe(generator, cfg, dtype, device=None, lead=()) -> dict:
    """Random init with the reference's scales (``lead`` prepends the
    stacked-unit axis)."""
    d, lead = cfg.d_model, tuple(lead)
    params = {
        "router": (d ** -0.5 * torch.randn(
            lead + (d, cfg.n_experts), generator=generator,
            device=device)).float(),
        "experts": init_mlp(generator, d, cfg.moe_d_ff, cfg.activation,
                            dtype, device=device,
                            lead=lead + (cfg.n_experts,)),
    }
    if cfg.n_shared_experts:
        params["shared"] = init_mlp(generator, d,
                                    cfg.n_shared_experts * cfg.moe_d_ff,
                                    cfg.activation, dtype, device=device,
                                    lead=lead)
    return params


# ---------------------------------------------------------------------------
# Routing and the dispatch plan
# ---------------------------------------------------------------------------

def route(x2: torch.Tensor, router: torch.Tensor, k: int):
    """``x2`` ``(T, d)`` -> ``(probs (T, E) float32, gates (T, K),
    experts (T, K))``: the top K by a stable descending sort (the lower
    expert first among equal probabilities, as ``jax.lax.top_k``), the
    gates renormalised."""
    probs = torch.softmax(x2.float() @ router, dim=-1)
    experts = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :k]
    gates = torch.gather(probs, -1, experts)
    return probs, gates / gates.sum(dim=-1, keepdim=True), experts


def aux_loss(probs: torch.Tensor, experts: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """``E * sum(me * ce)``: ``me`` the mean probability of each expert,
    ``ce`` its mean count of choices a token (no gradient)."""
    me = probs.mean(dim=0)
    ce = F.one_hot(experts, n_experts).sum(dim=1).float().mean(dim=0)
    return n_experts * torch.sum(me * ce)


def capacity(cfg, tokens: int) -> int:
    """The reference's ``int(cf * tokens * K / E) + 1``."""
    return int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts) + 1


def dispatch_plan(experts: torch.Tensor, n_experts: int, cap: int) -> dict:
    """The capacity buffer's plan for ``experts`` ``(G, N)``: each group's
    flat expert ids in (token, k) order (G = 1 on the flat route, one
    group a batch row on the grouped one).

    ``rank`` ``(G, N)`` is each contribution's rank within its expert and
    group, ``slot = min(rank, cap)``, ``kept = rank < cap``.  The buffer
    holds ``(E, G, cap)`` rows: ``to_buffer`` ``(G N,)`` is each kept
    contribution's buffer row (``E G cap`` for a dropped one) and
    ``from_buffer`` ``(E G cap,)`` each buffer row's contribution (``G N``
    for an empty row), the inverse map."""
    G, N = experts.shape
    dev = experts.device
    order = torch.argsort(experts, dim=-1, stable=True)
    ordered = torch.gather(experts, -1, order)
    starts = torch.searchsorted(
        ordered, torch.arange(n_experts, device=dev).expand(G, n_experts)
        .contiguous())
    ranked = torch.arange(N, device=dev) - torch.gather(starts, -1, ordered)
    rank = torch.empty_like(ranked).scatter_(-1, order, ranked)
    kept = rank < cap
    n_rows = n_experts * G * cap
    row = (experts * G + torch.arange(G, device=dev)[:, None]) * cap + rank
    to_buffer = torch.where(kept, row, n_rows).reshape(-1)
    # dropped contributions all land on the extra last entry, cut off
    from_buffer = torch.full((n_rows + 1,), G * N, dtype=torch.long,
                             device=dev)
    from_buffer.scatter_(0, to_buffer, torch.arange(G * N, device=dev))
    return {"rank": rank, "slot": rank.clamp(max=cap), "kept": kept,
            "to_buffer": to_buffer, "from_buffer": from_buffer[:n_rows]}


def _take(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``src[index]``, a zero row where ``index == len(src)``."""
    n = src.shape[0]
    rows = src.index_select(0, index.clamp(max=max(n - 1, 0)))
    return torch.where((index < n)[:, None], rows, rows.new_zeros(()))


class _Rows(torch.autograd.Function):
    """``out[i] = src[index[i]]`` for an ``index`` that reads each row of
    ``src`` at most once (``len(src)`` reads a zero row).  ``inverse`` is
    its inverse map (``inverse[index[i]] = i``, ``len(out)`` where no row
    reads), so the backward is the gather ``grad[inverse]``: no two
    values are added into one address, in either direction."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _take(src, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        return _take(grad, inverse), None, None


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

def _moe(params, x: torch.Tensor, cfg, groups: int):
    """The MoE over ``x`` ``(B, S, d)`` in ``groups`` groups of tokens
    (1, or B on the grouped route), each with its own capacity."""
    B, S, d = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    with record_function("moe.router"):
        probs, gates, experts = route(xt, params["router"], K)
        aux = aux_loss(probs, experts, E)
    cap = capacity(cfg, T // groups)
    with record_function("moe.dispatch"):
        plan = dispatch_plan(experts.reshape(groups, -1), E, cap)
        rows = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
        buf = _Rows.apply(rows, plan["from_buffer"], plan["to_buffer"])
    with record_function("moe.experts"):
        out = mlp(params["experts"], buf.reshape(E, groups * cap, d),
                  cfg.activation)
    with record_function("moe.combine"):
        gathered = _Rows.apply(out.reshape(E * groups * cap, d),
                               plan["to_buffer"], plan["from_buffer"])
        gate = torch.where(plan["kept"].reshape(-1), gates.reshape(-1), 0.0)
        contrib = (gate[:, None] * gathered).to(x.dtype).reshape(T, K, d)
        y = contrib[:, 0]
        for k in range(1, K):
            y = y + contrib[:, k]
    if cfg.n_shared_experts:
        with record_function("moe.shared"):
            y = y + mlp(params["shared"], xt, cfg.activation)
    return y.reshape(B, S, d), aux


def moe_ffn_grouped(params, x: torch.Tensor, cfg):
    """The per-row route (``cfg.moe_grouped``): capacity a batch row,
    ``C_row = int(cf * S * K / E) + 1``; the aux loss over all tokens."""
    return _moe(params, x, cfg, groups=x.shape[0])


def moe_ffn(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar)."""
    if cfg.moe_grouped and x.shape[1] > 1:
        return moe_ffn_grouped(params, x, cfg)
    return _moe(params, x, cfg, groups=1)
