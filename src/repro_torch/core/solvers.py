"""Local training solvers (counterpart of ``repro/core/solvers.py``).

Every solver approximates the local proximal update

    x_{i,k+1} ~= prox_{rho f_i}(v_i) = argmin_w d_i(w),
    d_i(w) = f_i(w) + ||w - v_i||^2 / (2 rho)

by ``N_e`` epochs, warm-started at the previous local state.  States,
reflections and gradients are a tensor (a packed ``(N, width)`` buffer or
a dense array) or a dict of tensors; with ``batched=True`` every leaf
carries a leading agent axis.

The gradient oracle is ``fgrad(w, epoch) -> grad`` (``(grad, aux)``
with ``has_aux``).  Solvers: ``gd``, ``agd`` (constant Nesterov
momentum), ``sgd`` (the oracle supplies the minibatch gradient) and
``noisy_gd`` (``w += -gamma grad d + t``, ``t ~ sqrt(2 gamma) N(0, tau^2)``).

The DP noise cannot reproduce JAX's threefry bits: it is drawn from a
``torch.Generator`` or injected through ``noise(epoch, w) -> tree``
(the parity tests inject the reference's own draws).

``use_fused=True`` routes the step through the fused
:mod:`repro_torch.kernels.fedplt_update` op whenever the step size is a
static float and the solver is not agd (the reference's condition).  The
iterate is a fresh buffer, or the ``out`` buffer the caller gives (a
group's rows of a grouped round's output); the warm start ``w0`` is never
written, and the fused op updates the iterate in place.  agd's plain
Eq. (12) step is elementwise and runs a leaf :data:`AGD_CHUNK` elements
at a time, in place on two float32 temporaries, so they stay at a chunk
at any width: the same numbers as one whole-leaf expression.

The moduli ``mu`` / ``L`` are Python floats, or ``(N, 1)`` float32
tensors of per-agent moduli (the dense front end's, Remark 1): the step
size is then a per-agent tensor computed in float32, as the reference
computes it from its vmapped moduli, and the fused op is not used (its
step size is static), as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.fedplt_update import ops as update_ops
from repro_torch.kernels.fedplt_update.ref import fedplt_update_ref

GradOracle = Callable[[Any, int], Any]

tree_map = pytree.tree_map

# elements of a leaf that agd's plain step takes at a time (a float32
# temporary of the step is at most this many elements: 64 MB)
AGD_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    name: str = "gd"                  # gd | agd | sgd | noisy_gd
    n_epochs: int = 5                 # N_e
    step_size: Optional[float] = None  # gamma; None -> optimal for moduli
    tau: float = 0.0                  # DP noise std (noisy_gd)
    clip: Optional[float] = None      # clip threshold C for grads (DP)

    def resolve_step_size(self, mu_d: float, L_d: float) -> float:
        """gamma* = 2/(L_d + mu_d) (Lemma 2)."""
        if self.step_size is not None:
            return self.step_size
        return 2.0 / (L_d + mu_d)


class StateBlock(NamedTuple):
    """Where one rank's stacked state ``w`` sits in the global ``(N, W)``
    state of a sharded round: agent rows ``rows`` of ``n_rows`` and, under
    a model axis that splits the columns, columns ``cols`` of ``width``
    (None: whole rows), with ``row_sum`` summing per-row partials over the
    ranks that share a row (the model group).  A tree of leaf blocks (the
    tree layout under a model axis) gives ``cuts`` instead of ``cols``:
    for each leaf in tree order, None where the leaf is whole, else its
    full row shape and this rank's index into it; ``row_sum`` then sums
    the split leaves' partials.  A plain ``(rows, n_rows)`` pair is a
    block of whole rows."""

    rows: slice
    n_rows: int
    cols: Optional[slice] = None
    width: Optional[int] = None
    row_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    cuts: Optional[tuple] = None


def grad_norm(g: Any, *, batched: bool = False,
              row_sum=None, cuts=None) -> torch.Tensor:
    """l2 norm across all leaves; per agent (leading axis) when
    ``batched``.  ``row_sum`` completes the per-agent squares of a column
    block over the ranks that hold the rest of each row; with ``cuts``
    (:class:`StateBlock`) only the split leaves' squares are partial."""
    leaves = pytree.tree_leaves(g)
    if batched:
        sqs = [torch.sum(torch.square(l.float()).reshape(l.shape[0], -1),
                         dim=-1) for l in leaves]
        if cuts is None:
            sq = sum(sqs)
            if row_sum is not None:
                sq = row_sum(sq)
        else:
            split = [q for q, c in zip(sqs, cuts) if c is not None]
            sq = sum(q for q, c in zip(sqs, cuts) if c is None)
            if split:
                sq = sq + row_sum(sum(split))
    else:
        sq = sum(torch.sum(torch.square(l.float())) for l in leaves)
    return torch.sqrt(sq)


def clip_grad(g: Any, clip: Optional[float], *, batched: bool = False,
              row_sum=None, cuts=None) -> Any:
    """Norm clipping ``g * min(1, C / ||g||)`` over the whole gradient
    (per agent when ``batched``; a column block's norm is completed by
    ``row_sum``, so an agent's norm is over its whole row; ``cuts``: see
    :func:`grad_norm`), in place."""
    if clip is None:
        return g
    nrm = grad_norm(g, batched=batched, row_sum=row_sum, cuts=cuts)
    factor = torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)
    for l in pytree.tree_leaves(g):
        f = factor.reshape((-1,) + (1,) * (l.ndim - 1)) if batched \
            else factor
        l.mul_(f.to(l.dtype))
    return g


def draw_noise(w: Any, scale: float, generator: Optional[torch.Generator],
               block=None) -> Any:
    """Gaussian noise ``scale * N(0, I)`` shaped like ``w``, drawn in
    float32 and stored in each leaf's dtype (the fused op casts it there
    anyway).  Drawn row by row so the float32 temporaries stay at one
    agent row.

    ``block`` (a :class:`StateBlock`, or a ``(rows, n_total)`` pair) says
    that ``w`` holds the agents ``rows`` of ``n_total`` (one rank's block
    of a sharded round): every leaf then draws all ``n_total`` rows in
    agent order and keeps its own; with ``block.cols`` each row is drawn
    at its full ``block.width`` and cut to the rank's columns, with
    ``block.cuts`` each leaf's row at its full shape and cut to the
    rank's block.  Each
    agent then gets the noise that an unsharded run draws for it from
    the same generator, and no two agents (and no two column blocks)
    share theirs, at the cost of the unsharded run's draws on every
    rank."""
    block = None if block is None else StateBlock(*block)

    def draw(shape, device):
        return scale * torch.randn(shape, generator=generator, device=device)

    def leaf(l, cut):
        if l.ndim < 2:
            if block is None:
                return draw(l.shape, l.device).to(l.dtype)
            return draw((block.n_rows,) + l.shape[1:],
                        l.device)[block.rows].to(l.dtype)
        rows, n = ((slice(0, l.shape[0]), l.shape[0]) if block is None
                   else block[:2])
        cols = None if block is None else block.cols
        index = cols if cut is None else cut[1]
        row_shape = (l.shape[1:] if index is None
                     else cut[0] if cut is not None else (block.width,))
        out = torch.empty_like(l)
        for r in range(n):
            d = draw(row_shape, l.device)
            if rows.start <= r < rows.stop:
                out[r - rows.start] = d if index is None else d[index]
        return out

    leaves, spec = pytree.tree_flatten(w)
    cuts = ((None,) * len(leaves) if block is None or block.cuts is None
            else block.cuts)
    return pytree.tree_unflatten([leaf(l, c) for l, c in zip(leaves, cuts)],
                                 spec)


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _by_chunks(op, dst: torch.Tensor, *srcs: torch.Tensor) -> None:
    """``op(dst, *srcs)`` for an elementwise ``op`` that writes ``dst``,
    over contiguous pieces of ``AGD_CHUNK`` elements of the flattened
    leaves, so that its temporaries stay small; one call when the leaf is
    small or a leaf is not contiguous."""
    leaves = (dst,) + srcs
    if dst.numel() <= AGD_CHUNK or not all(l.is_contiguous() for l in leaves):
        op(dst, *srcs)
        return
    flat = [l.view(-1) for l in leaves]
    for c in range(0, flat[0].numel(), AGD_CHUNK):
        op(*(f[c:c + AGD_CHUNK] for f in flat))


def local_train(fgrad: GradOracle, w0: Any, v: Any, rho: float,
                cfg: SolverConfig, mu, L, *, batched: bool = False,
                has_aux: bool = False, use_fused: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Callable[[int, Any], Any]] = None,
                block: Optional[StateBlock] = None, out: Any = None):
    """Run ``cfg.n_epochs`` epochs of the chosen solver on d(w).

    ``mu``/``L`` are the moduli of f_i (d adds 1/rho to both): floats,
    or ``(N, 1)`` tensors of per-agent moduli.  Returns ``w_{N_e}`` (and
    the per-epoch oracle aux stacked on a leading axis when ``has_aux``).
    ``noise(epoch, w)`` overrides the noisy_gd draw (required with
    per-agent moduli); ``block`` places a sharded ``w`` in the global
    state, for the noise (:func:`draw_noise`) and the clip norm
    (:func:`clip_grad`).  ``out`` (shaped like ``w0``) holds the iterate
    instead of a fresh clone of ``w0``, and is returned.
    """
    mu_d, L_d = mu + 1.0 / rho, L + 1.0 / rho
    gamma = cfg.resolve_step_size(mu_d, L_d)
    inv_rho = 1.0 / rho
    fused = use_fused and isinstance(gamma, float) and cfg.name != "agd"
    if cfg.name not in ("gd", "sgd", "noisy_gd", "agd"):
        raise ValueError(f"unknown solver {cfg.name!r}")
    if cfg.name == "noisy_gd" and noise is None and isinstance(
            gamma, torch.Tensor):
        raise ValueError("noisy_gd with per-agent moduli needs the noise "
                         "draws (noise=)")

    def dgrad(w, epoch):
        out = fgrad(w, epoch)
        g, aux = out if has_aux else (out, None)
        sb = None if block is None else StateBlock(*block)
        return clip_grad(g, cfg.clip, batched=batched,
                         row_sum=None if sb is None else sb.row_sum,
                         cuts=None if sb is None else sb.cuts), aux

    def step_leaf(wl, gl, vl, tl):
        """w - gamma (g + inv_rho (w - v)) [+ t], float32 accumulation,
        written into ``wl``."""
        if fused:
            return update_ops.fedplt_update(wl, gl, vl, tl, gamma=gamma,
                                            inv_rho=inv_rho, out=wl)
        return wl.copy_(fedplt_update_ref(wl, gl, vl, tl, gamma=gamma,
                                          inv_rho=inv_rho))

    w = (tree_map(torch.clone, w0) if out is None
         else tree_map(lambda o, x0: o.copy_(x0), out, w0))
    auxes = []

    if cfg.name in ("gd", "sgd", "noisy_gd"):
        for e in range(cfg.n_epochs):
            g, aux = dgrad(w, e)
            t = None
            if cfg.name == "noisy_gd":
                t = (noise(e, w) if noise is not None
                     else draw_noise(w, math.sqrt(2.0 * gamma) * cfg.tau,
                                     generator, block))
            if t is None:
                tree_map(lambda wl, gl, vl: step_leaf(wl, gl, vl, None),
                         w, g, v)
            else:
                tree_map(step_leaf, w, g, v, t)
            auxes.append(aux)
    else:
        # agd, Eq. (12): constant step 1/L_d, constant momentum beta
        beta = ((_sqrt(L_d) - _sqrt(mu_d)) / (_sqrt(L_d) + _sqrt(mu_d)))

        # each operation rounds as the one expression ``(w - (g + inv_rho
        # (w - v)) / L_d)`` and ``u + beta (u - u_prev)`` rounds it, the
        # operands in float32 (a bf16 operand is widened exactly), with
        # two float32 temporaries a call
        def gradient_step(ul, wl, gl, vl):
            a = wl.float()
            b = torch.sub(a, vl).mul_(inv_rho).add_(gl).div_(L_d)
            ul.copy_(torch.sub(a, b, out=b))

        def momentum(wl, ul, upl):
            a = ul.float()
            wl.copy_(torch.sub(a, upl).mul_(beta).add_(a))

        # per-agent (N, 1) moduli broadcast over whole rows: no chunks
        chunked = _by_chunks if isinstance(L_d, float) else (
            lambda op, *ls: op(*ls))
        u_prev = tree_map(torch.clone, w0)
        u = tree_map(torch.empty_like, w0)
        for e in range(cfg.n_epochs):
            g, aux = dgrad(w, e)
            tree_map(lambda ul, wl, gl, vl: chunked(
                gradient_step, ul, wl, gl, vl), u, w, g, v)
            tree_map(lambda wl, ul, upl: chunked(momentum, wl, ul, upl),
                     w, u, u_prev)
            u_prev, u = u, u_prev       # the next epoch's u reuses a buffer
            auxes.append(aux)

    if has_aux:
        return w, (torch.stack(auxes) if auxes[0] is not None else None)
    return w


def solver_contraction(cfg: SolverConfig, mu: float, L: float,
                       rho: float) -> float:
    """Contraction factor of the *whole* local training map
    (chi^{N_e} for GD-type, chi(N_e) of Prop. 3 for AGD)."""
    mu_d, L_d = mu + 1.0 / rho, L + 1.0 / rho
    if cfg.name in ("gd", "sgd", "noisy_gd"):
        gamma = cfg.resolve_step_size(mu_d, L_d)
        chi = max(abs(1.0 - gamma * mu_d), abs(1.0 - gamma * L_d))
        return float(chi ** cfg.n_epochs)
    if cfg.name == "agd":
        kappa = L_d / mu_d
        return float((1.0 + kappa)
                     * (1.0 - (1.0 / kappa) ** 0.5) ** cfg.n_epochs)
    raise ValueError(cfg.name)
