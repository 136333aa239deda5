"""Launcher of the fused local-step CUDA kernel (``csrc/fedplt_update.cu``).

Replaces ``repro/kernels/fedplt_update/kernel.py``'s ``fedplt_update_2d``
(``_update_kernel``, ``_update_noise_kernel``).  Bound by bytes: three
reads and one write per element (four reads with the noise operand);
the source file's header says how the design meets that bound.  One flat
pass over any contiguous buffer -- the trainer hands it the whole packed
``(N, width)`` state -- with no padding to tiles: the ragged tail is a
masked scalar path.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (DTYPE_CODES, F32, I64, INT, PTR,
                                       check_launch, check_operands, ptr,
                                       stream_of, vector_ok)

SOURCE = Path(__file__).parent / "csrc" / "fedplt_update.cu"


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_fedplt_update.argtypes = [PTR, PTR, PTR, PTR, PTR, I64, INT,
                                        INT, F32, F32, PTR]
    lib.repro_fedplt_update.restype = INT
    return lib


def fedplt_update(w: torch.Tensor, g, v, t, out: torch.Tensor, gamma: float,
                  inv_rho: float) -> torch.Tensor:
    """``out = w - gamma (g + inv_rho (w - v)) [+ t]``; ``out`` may be
    ``w`` (in place)."""
    check_operands("fedplt_update", w, g=g, v=v, t=t, out=out)
    n = w.numel()
    if n == 0:
        return out
    vec = vector_ok(n, w, g, v, t, out)
    check_launch("fedplt_update", _lib().repro_fedplt_update(
        ptr(w), ptr(g), ptr(v), ptr(t), ptr(out), n, DTYPE_CODES[w.dtype],
        int(vec), gamma, inv_rho, stream_of(w)))
    return out
