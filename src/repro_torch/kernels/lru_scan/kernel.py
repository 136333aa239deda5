"""Launchers of the lru_scan CUDA kernels (``csrc/lru_scan.cu``).

Replaces ``repro/kernels/lru_scan/kernel.py``'s ``lru_scan_bsw``
(``_lru_kernel``), and adds the backward that the reference leaves to
autodiff.  Bound by bytes: the forward reads a and b and writes h, the
backward reads g, a and h and writes da and db, each once; the source
file's header says how the design meets that bound.

Every operand is a contiguous ``(B, S, W)`` CUDA tensor of one dtype,
float32 or bfloat16 (the TPU kernel's types); anything else raises.
The library is compiled on the first launch (:mod:`repro_torch.kernels.build`).

Two kernels walk each ``(b, channel)`` column in time order with the same
rounded operations; the C launcher picks one from the operands.  The ring
kernel gives a CTA, one warp, a tile of 32 columns of one batch row and
cuts time into blocks of 32 steps, which TMA copies into a ring in shared
memory ahead of the walk and back out of it; it takes 16-byte aligned
operands whose rows are a multiple of 16 bytes.  The per-column kernel
gives a thread one column and takes any others.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (I64, INT, PTR, check_launch,
                                       check_operands, ptr, stream_of)

SOURCE = Path(__file__).parent / "csrc" / "lru_scan.cu"

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_lru_scan_fwd.argtypes = [PTR] * 3 + [I64] * 3 + [INT, PTR]
    lib.repro_lru_scan_fwd.restype = INT
    lib.repro_lru_scan_bwd.argtypes = [PTR] * 5 + [I64] * 3 + [INT, PTR]
    lib.repro_lru_scan_bwd.restype = INT
    lib.repro_lru_scan_routes.argtypes = [PTR]
    lib.repro_lru_scan_routes.restype = None
    return lib


def route_counts() -> dict[str, int]:
    """Launches so far of the ring kernels (``"ring"``) and of the
    per-column kernels (``"per-column"``), forward and backward together,
    as the C launcher counts them where each launch succeeds."""
    out = (ctypes.c_int64 * 2)()
    _lib().repro_lru_scan_routes(out)
    return {"ring": out[0], "per-column": out[1]}


def check_scan(name: str, a: torch.Tensor, **others) -> None:
    """Raise unless ``a`` is a contiguous ``(B, S, W)`` CUDA tensor of
    float32 or bfloat16 and every other operand matches it (device,
    dtype, shape, contiguity)."""
    if a.ndim != 3:
        raise ValueError(f"{name}: operands must be (B, S, W), got "
                         f"{tuple(a.shape)}")
    if a.dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"not {a.dtype}")
    check_operands(name, a, **others)


def lru_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, W) in a's dtype from the forward kernel."""
    check_scan("lru_scan_fwd", a, b=b)
    h = torch.empty_like(a)
    if a.numel() == 0:
        return h
    B, S, W = a.shape
    check_launch("lru_scan_fwd", _lib().repro_lru_scan_fwd(
        ptr(a), ptr(b), ptr(h), B, S, W, DTYPES[a.dtype], stream_of(a)))
    return h


def lru_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """``(da, db)`` (B, S, W) in a's dtype from the backward kernel."""
    check_scan("lru_scan_bwd", a, h=h, g=g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    B, S, W = a.shape
    check_launch("lru_scan_bwd", _lib().repro_lru_scan_bwd(
        ptr(a), ptr(h), ptr(g), ptr(da), ptr(db), B, S, W, DTYPES[a.dtype],
        stream_of(a)))
    return da, db
