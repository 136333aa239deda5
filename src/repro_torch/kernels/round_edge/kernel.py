"""Launchers of the round-edge CUDA kernels (``csrc/round_edge.cu``).

Replaces ``repro/kernels/round_edge/kernel.py``'s ``round_uplink_2d``
(``_uplink_kernel``, ``_uplink_lagged_kernel``), ``round_downlink_2d``
(``_downlink_kernel``, ``_downlink_lagged_kernel``, ``_downlink_body``),
and the sharded halves ``round_uplink_partial_2d``
(``_partial_sum_kernel``) and ``round_downlink_presummed_2d``
(``_downlink_presummed_kernel``).
Bound by bytes: ``(2N + 1) M`` elements for the exact uplink and ``5 N M``
for the exact downlink (one more ``N M`` each with the lagged ``t``),
``(N + 1) M`` for the partial sum and ``(5 N + 1) M`` for the presummed
downlink;
the source file's header says how the design meets that bound.  The
downlink recomputes ``y`` from the seen rows rather than reading the
uplink's output: the exact downlink reads those rows anyway as ``z``.

The library is compiled on the first launch (:mod:`repro_torch.kernels.build`).
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (DTYPE_CODES, F32, I64, INT, PTR,
                                       check_launch, check_operands, ptr,
                                       stream_of, vector_ok)

SOURCE = Path(__file__).parent / "csrc" / "round_edge.cu"


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_round_uplink.argtypes = [PTR, PTR, PTR, PTR, I64, I64, INT, INT,
                                       INT, F32, F32, PTR]
    lib.repro_round_uplink.restype = INT
    lib.repro_round_downlink.argtypes = [PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                         I64, I64, INT, INT, INT, F32, F32,
                                         F32, PTR]
    lib.repro_round_downlink.restype = INT
    lib.repro_round_uplink_partial.argtypes = [PTR, PTR, I64, I64, INT, INT,
                                               PTR]
    lib.repro_round_uplink_partial.restype = INT
    lib.repro_round_downlink_presummed.argtypes = [PTR, PTR, PTR, PTR, PTR,
                                                   PTR, PTR, I64, I64, INT,
                                                   INT, F32, PTR]
    lib.repro_round_downlink_presummed.restype = INT
    return lib


def round_uplink(z: torch.Tensor, t, code: int, a: float, b: float):
    """``(y (1, M), v (N, M))`` from the kernel; ``t`` None = exact."""
    check_operands("round_uplink", z, t=t)
    n, m = z.shape
    y = torch.empty((1, m), dtype=z.dtype, device=z.device)
    v = torch.empty_like(z)
    if m == 0:
        return y, v
    seen = z if t is None else t
    vec = vector_ok(m, z, seen, y, v)
    check_launch("round_uplink", _lib().repro_round_uplink(
        ptr(seen), ptr(z), ptr(y), ptr(v), n, m, DTYPE_CODES[z.dtype],
        int(vec), code, a, b, stream_of(z)))
    return y, v


def round_downlink(x, w, z, u, t, code: int, a: float, b: float,
                   c: float):
    """``(x', z')`` from the kernel; ``u`` is the ``(N,)`` float32
    participation row, ``c = 2 * damping``."""
    check_operands("round_downlink", x, w=w, z=z, t=t)
    n, m = x.shape
    u = u.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    if u.numel() != n:
        raise ValueError(f"round_downlink: u has {u.numel()} entries for "
                         f"{n} agents")
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    if m == 0:
        return x_out, z_out
    seen = z if t is None else t
    vec = vector_ok(m, x, w, z, seen, x_out, z_out)
    check_launch("round_downlink", _lib().repro_round_downlink(
        ptr(x), ptr(w), ptr(z), ptr(seen), ptr(u), ptr(x_out), ptr(z_out),
        n, m, DTYPE_CODES[x.dtype], int(vec), code, a, b, c,
        stream_of(x)))
    return x_out, z_out


def round_uplink_partial(seen: torch.Tensor) -> torch.Tensor:
    """The ``(1, M)`` column sums of one rank's ``(N_local, M)`` rows, in
    ``seen``'s dtype."""
    check_operands("round_uplink_partial", seen)
    n, m = seen.shape
    s = torch.empty((1, m), dtype=seen.dtype, device=seen.device)
    if m == 0:
        return s
    check_launch("round_uplink_partial", _lib().repro_round_uplink_partial(
        ptr(seen), ptr(s), n, m, DTYPE_CODES[seen.dtype],
        int(vector_ok(m, seen, s)), stream_of(seen)))
    return s


def round_downlink_presummed(x, w, z, y, u, c: float):
    """``(x', z')`` of one rank's rows from the kernel, given the ``(1, M)``
    coordinator row ``y``; ``u`` is the rank's ``(N_local,)``
    participation row, ``c = 2 * damping``."""
    check_operands("round_downlink_presummed", x, w=w, z=z)
    n, m = x.shape
    if tuple(y.shape) != (1, m):
        raise ValueError(f"round_downlink_presummed: y has shape "
                         f"{tuple(y.shape)}, want {(1, m)}")
    check_operands("round_downlink_presummed", y)
    if y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"round_downlink_presummed: y is {y.dtype} on "
                         f"{y.device}, want {x.dtype} on {x.device}")
    u = u.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    if u.numel() != n:
        raise ValueError(f"round_downlink_presummed: u has {u.numel()} "
                         f"entries for {n} agents")
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    if m == 0:
        return x_out, z_out
    vec = vector_ok(m, x, w, z, y, x_out, z_out)
    check_launch("round_downlink_presummed",
                 _lib().repro_round_downlink_presummed(
                     ptr(x), ptr(w), ptr(z), ptr(y), ptr(u), ptr(x_out),
                     ptr(z_out), n, m, DTYPE_CODES[x.dtype], int(vec), c,
                     stream_of(x)))
    return x_out, z_out
