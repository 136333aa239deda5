"""Carry parameters and problems between the reference and the port.

The reference's parameter tree (as numpy arrays) is
``{"stages": [{"0": {...}, "1": {...}}, ...], "embed", "final_norm"}``,
with ``"lm_head"`` ``(d_model, vocab)`` when the head is untied, and
each stage's units stacked on axis 0; the port's parameters are
``{dotted name: tensor}`` named after the same paths
(``stages.0.1.attn.wq``).  The mapping is by name only, so any tree of
that structure -- agent-stacked states, gradients, noise draws -- converts
the same way.

A dense problem crosses as its arrays: :func:`problem_from_arrays` and
:func:`quadratic_from_arrays` build the port's problem from the
reference's ``(A, b)`` or ``(Q, c)`` (as numpy), so that both packages
solve the same problem.  :func:`rank_block` cuts a reference state or a
problem's per-agent arrays to one rank's block of an ``(agent, model)``
mesh, by the port's row and column rules.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.problem import LogRegProblem, QuadraticProblem
from repro_torch.fed.sharding import block_cols, block_rows
from repro_torch.models.model import build_model


def _flatten(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def params_from_jax(tree, cfg: ModelConfig, device="cpu") -> dict:
    """The reference's parameter tree (numpy leaves) as the port's
    ``{name: tensor}``, checked against the port's names and the
    trailing (per-parameter) shapes."""
    flat = _flatten(tree)
    expect = build_model(cfg).param_shapes()
    if set(flat) != set(expect):
        raise ValueError(f"parameter names differ: only in the tree "
                         f"{sorted(set(flat) - set(expect))}, only in the "
                         f"port {sorted(set(expect) - set(flat))}")
    out = {}
    for name, (shape, _) in expect.items():
        t = _to_tensor(flat[name])
        if tuple(t.shape[t.ndim - len(shape):]) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not end "
                             f"in {shape}")
        out[name] = t.to(device)
    return out


def params_to_jax(params: dict) -> dict:
    """Inverse of :func:`params_from_jax`: the reference's tree structure
    with numpy leaves (bfloat16 leaves come back as float32)."""
    tree: dict = {}
    for name, t in params.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = _to_numpy(t)
    stages = tree.get("stages", {})
    tree["stages"] = [stages[str(i)] for i in range(len(stages))]
    return tree


def problem_from_arrays(A, b, eps: float = 0.5, nonconvex: bool = False,
                        device="cpu") -> LogRegProblem:
    """The port's :class:`LogRegProblem` on the reference's features
    ``A`` ``(N, q, n)`` and labels ``b`` ``(N, q)``."""
    return LogRegProblem(A=_to_tensor(A).to(device),
                         b=_to_tensor(b).to(device), eps=eps,
                         nonconvex=nonconvex)


def quadratic_from_arrays(Q, c, device="cpu") -> QuadraticProblem:
    """The port's :class:`QuadraticProblem` on the reference's ``Q``
    ``(N, n, n)`` and ``c`` ``(N, n)``."""
    return QuadraticProblem(Q=_to_tensor(Q).to(device),
                            c=_to_tensor(c).to(device))


def rank_block(a, mesh_shape, coord, *, cols: bool = True) -> torch.Tensor:
    """The block of an agent-stacked array ``a`` (numpy, ``(N, ...)``)
    that the rank at mesh coordinate ``coord = (r, c)`` of an
    ``mesh_shape = (agents, model)`` mesh holds: agents ``[r N / agents,
    (r + 1) N / agents)`` and, with ``cols``, the column block of the
    last axis (:func:`repro_torch.fed.sharding.block_cols`: replicated
    where ``model`` does not divide it).  ``cols=False`` keeps whole rows,
    as for a problem's ``A_i`` and ``b_i``."""
    t = _to_tensor(a)
    t = t[block_rows(t.shape[0], mesh_shape[0], coord[0])]
    if cols:
        t = t[..., block_cols(t.shape[-1], mesh_shape[1], coord[1])]
    return t.contiguous()
