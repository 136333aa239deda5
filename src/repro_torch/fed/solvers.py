"""Pluggable per-agent local-solver registry (counterpart of
``repro/fed/solvers.py``).

A name maps to a factory ``(scfg, fgrad, rho, mu, L, *, use_fused,
has_aux, generator, noise, block) -> solver`` and the solver maps
the stacked states ``(x, v) -> (w, aux)``, warm-started at ``x``.  The core solvers
gd / agd / sgd / noisy_gd are served by
:func:`repro_torch.core.solvers.local_train`; they also take ``out=`` (a
buffer shaped like ``x`` that holds the iterate: a group's rows of a
grouped round's output) and say so with ``solver.takes_out``.  In a
grouped round (:func:`repro_torch.fed.engine.run_solvers`) each group has
its own solver, built with its ``SolverConfig``, moduli and oracle.

Packed layout: the reference runs gd / agd / sgd directly on the
``(N, width)`` buffer and unpacks around the tree solver for noisy_gd and
clipped runs, only to keep JAX's per-leaf PRNG streams and reduction
order bit for bit.  The port reproduces neither (its noise comes from a
``torch.Generator``), so every core solver runs directly on the buffer:
noisy_gd draws one noise buffer per epoch, and the clip norm reduces over
the whole row, whose padding columns hold zero gradient.  A custom
registered solver still gets the tree through :func:`wrap_packed_solver`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.fed.compress import pack_leaves, unpack_leaves

# (x_stack, v_stack) -> (w_stack, aux)
LocalSolver = Callable[[Any, Any], Tuple[Any, Any]]
SolverFactory = Callable[..., LocalSolver]

_REGISTRY: Dict[str, SolverFactory] = {}


def register_solver(name: str) -> Callable[[SolverFactory], SolverFactory]:
    """Decorator registering a local-solver factory under ``name``."""

    def deco(fn: SolverFactory) -> SolverFactory:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_solver(name: str) -> SolverFactory:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered: "
            f"{', '.join(available_solvers())}") from None


def available_solvers() -> list[str]:
    return sorted(_REGISTRY)


def make_local_solver(solver_cfg, fgrad, rho: float, mu: float = 0.0,
                      L: float = 0.0, *, use_fused: bool = False,
                      has_aux: bool = False, generator=None,
                      noise=None, block=None) -> LocalSolver:
    """Build the solver registered under ``solver_cfg.name``;
    ``fgrad(w_stack, epoch)`` returns the stacked gradient (``(grad,
    aux)`` with ``has_aux``).  ``block`` (a
    :class:`repro_torch.core.solvers.StateBlock`) places a sharded round's
    row and column block in the global state, for the random draws
    (:func:`repro_torch.core.solvers.draw_noise`) and the clip norm."""
    factory = get_solver(solver_cfg.name)
    return factory(solver_cfg, fgrad, rho, mu, L, use_fused=use_fused,
                   has_aux=has_aux, generator=generator, noise=noise,
                   block=block)


CORE_SOLVERS = ("gd", "agd", "sgd", "noisy_gd")

# every core solver runs directly on the packed buffer (module docstring)
PACKED_DIRECT_SOLVERS = CORE_SOLVERS


def _core_local_train(scfg, fgrad, rho, mu, L, *, use_fused, has_aux,
                      generator, noise, block):
    from repro_torch.core.solvers import local_train

    def solver(x, v, out=None):
        res = local_train(fgrad, x, v, rho, scfg, mu, L, batched=True,
                          has_aux=has_aux, use_fused=use_fused,
                          generator=generator, noise=noise,
                          block=block, out=out)
        return res if has_aux else (res, None)

    # a grouped round hands the solver its rows of the output buffer
    solver.takes_out = True
    return solver


for _name in CORE_SOLVERS:
    register_solver(_name)(_core_local_train)
del _name


def wrap_packed_solver(solver: LocalSolver, meta) -> LocalSolver:
    """Adapt a tree-form solver to the packed layout: unpack (views),
    solve on the tree, pack the result."""

    def packed(x_buf, v_buf):
        w, aux = solver(unpack_leaves(x_buf, meta), unpack_leaves(v_buf, meta))
        return pack_leaves(w, meta)[0], aux

    return packed


def make_packed_local_solver(solver_cfg, fgrad_buf, rho: float,
                             mu: float = 0.0, L: float = 0.0, *, meta,
                             use_fused: bool = False, has_aux: bool = False,
                             generator=None, noise=None,
                             block=None) -> LocalSolver:
    """A solver on the resident ``(N, width)`` buffer.  ``fgrad_buf`` is
    the buffer oracle ``(w_buf, epoch) -> g_buf`` (``(g_buf, aux)`` with
    ``has_aux``).  Core solvers run on the buffer directly; a custom
    solver is wrapped around the tree, its oracle packing and unpacking."""
    if solver_cfg.name in PACKED_DIRECT_SOLVERS:
        return make_local_solver(solver_cfg, fgrad_buf, rho, mu, L,
                                 use_fused=use_fused, has_aux=has_aux,
                                 generator=generator, noise=noise,
                                 block=block)

    def fgrad_tree(w_tree, epoch):
        out = fgrad_buf(pack_leaves(w_tree, meta)[0], epoch)
        g, aux = out if has_aux else (out, None)
        g_tree = unpack_leaves(g, meta)
        return (g_tree, aux) if has_aux else g_tree

    return wrap_packed_solver(
        make_local_solver(solver_cfg, fgrad_tree, rho, mu, L,
                          use_fused=use_fused, has_aux=has_aux,
                          generator=generator, noise=noise,
                          block=block), meta)
