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

``ssm_fwd`` / ``ssm_bwd`` launch the selective scan with its output
contraction (``csrc/ssm_scan.cu``, below): the Mamba block's time mixing
from ``(dt, u, B, C, A, D)`` to ``y`` without a ``(B, S, d_in, n)`` state.
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


# ---------------------------------------------------------------------------
# The selective scan with its output contraction (csrc/ssm_scan.cu)
# ---------------------------------------------------------------------------
#
# Replaces no Pallas kernel: the counterpart of the reference's XLA stand-ins
# ssm_mix_seq and ssm_mix_fused (repro/models/ssm.py:96, :123).  Bound by
# its exponentials (forward) and its bytes (backward); the source file's
# header says how the design meets that bound.

SSM_SOURCE = Path(__file__).parent / "csrc" / "ssm_scan.cu"
SSM_MAX_STATE = 32          # kMaxN
SSM_MAX_CHUNK = 128         # kMaxChunk: the longest checkpoint span


@functools.cache
def _ssm_lib():
    lib = build.load(SSM_SOURCE)
    lib.repro_ssm_scan_fwd.argtypes = [PTR] * 8 + [I64] * 5 + [INT, INT, PTR]
    lib.repro_ssm_scan_fwd.restype = INT
    lib.repro_ssm_scan_bwd.argtypes = [PTR] * 15 + [I64] * 5 + [INT, INT, PTR]
    lib.repro_ssm_scan_bwd.restype = INT
    lib.repro_ssm_scan_scratch.argtypes = [I64] * 4
    lib.repro_ssm_scan_scratch.restype = I64
    lib.repro_ssm_scan_block_channels.argtypes = [I64]
    lib.repro_ssm_scan_block_channels.restype = INT
    return lib


def ssm_block_channels(n: int) -> int:
    """The channels of a kernel block at state n, as the library reports
    it (``ref.block_channels`` mirrors it)."""
    return _ssm_lib().repro_ssm_scan_block_channels(n)


def check_ssm(name, dt, u, Bm, Cm, A, D, scan_dtype, chunk, **more) -> None:
    """Raise unless dt (B, S, d_in) is a contiguous float32 CUDA tensor, u
    matches its shape (float32 or bfloat16), B and C are (B, S, n), A is
    (d_in, n) and D (d_in,), all float32, on dt's card and contiguous;
    1 <= n <= 32, scan_dtype float32 or bfloat16, 1 <= chunk <= 128; and
    ``more`` (name: (tensor, shape)) float32 of the shapes given."""
    if dt.ndim != 3:
        raise ValueError(f"{name}: dt must be (B, S, d_in), got "
                         f"{tuple(dt.shape)}")
    if dt.dtype != torch.float32:
        raise TypeError(f"{name}: dt must be float32, not {dt.dtype}")
    Bn, S, d_in = dt.shape
    if A.ndim != 2 or A.shape[0] != d_in:
        raise ValueError(f"{name}: A must be (d_in, n) = ({d_in}, n), got "
                         f"{tuple(A.shape)}")
    n = A.shape[1]
    if not 1 <= n <= SSM_MAX_STATE:
        raise ValueError(f"{name}: the kernel takes a state of 1 to "
                         f"{SSM_MAX_STATE}, not {n}")
    if scan_dtype not in DTYPES:
        raise TypeError(f"{name}: scan dtype float32 or bfloat16, not "
                        f"{scan_dtype}")
    if not 1 <= chunk <= SSM_MAX_CHUNK:
        raise ValueError(f"{name}: checkpoint span 1 to {SSM_MAX_CHUNK}, "
                         f"not {chunk}")
    if u.dtype not in DTYPES:
        raise TypeError(f"{name}: u must be float32 or bfloat16, not "
                        f"{u.dtype}")
    check_operands(name, dt)
    check_operands(name, u)
    if u.shape != dt.shape or u.device != dt.device:
        raise ValueError(f"{name}: u is {tuple(u.shape)} on {u.device}, "
                         f"want {tuple(dt.shape)} on {dt.device}")
    want = {"B": (Bm, (Bn, S, n)), "C": (Cm, (Bn, S, n)), "A": (A, (d_in, n)),
            "D": (D, (d_in,)), **more}
    for key, (t, shape) in want.items():
        if t.device != dt.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"want float32 on {dt.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ssm_fwd(dt, u, Bm, Cm, A, D, scan_dtype=torch.float32, chunk=128):
    """``(y, ckpt)`` from the forward kernel: y (B, S, d_in) float32 and
    the float32 state ahead of every span of ``chunk`` steps, (B,
    ceil(S / chunk), d_in, n), which the backward reads."""
    check_ssm("ssm_scan_fwd", dt, u, Bm, Cm, A, D, scan_dtype, chunk)
    Bn, S, d_in = dt.shape
    n = A.shape[1]
    y = torch.empty_like(dt)
    ckpt = dt.new_empty((Bn, -(-S // chunk), d_in, n))
    if dt.numel() == 0:
        return y, ckpt
    check_launch("ssm_scan_fwd", _ssm_lib().repro_ssm_scan_fwd(
        ptr(dt), ptr(u), ptr(Bm), ptr(Cm), ptr(A), ptr(D), ptr(y), ptr(ckpt),
        Bn, S, d_in, n, chunk, DTYPES[u.dtype], DTYPES[scan_dtype],
        stream_of(dt)))
    return y, ckpt


def ssm_bwd(dt, u, Bm, Cm, A, D, ckpt, gy, scan_dtype=torch.float32,
            chunk=128):
    """``(ddt, du, dB, dC, dA, dD)``, float32, from the backward kernel and
    its fixed-order reduction, given the forward's ``ckpt`` and the
    upstream gradient ``gy`` of y."""
    Bn, S, d_in = dt.shape
    n = A.shape[1] if A.ndim == 2 else 0
    check_ssm("ssm_scan_bwd", dt, u, Bm, Cm, A, D, scan_dtype, chunk,
              gy=(gy, (Bn, S, d_in)),
              ckpt=(ckpt, (Bn, -(-S // chunk), d_in, n)))
    ddt, du = torch.empty_like(dt), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    if dt.numel() == 0:
        return ddt, du, dB.zero_(), dC.zero_(), dA.zero_(), dD.zero_()
    lib = _ssm_lib()
    scratch = dt.new_empty((lib.repro_ssm_scan_scratch(Bn, S, d_in, n),))
    check_launch("ssm_scan_bwd", lib.repro_ssm_scan_bwd(
        ptr(dt), ptr(u), ptr(Bm), ptr(Cm), ptr(A), ptr(D), ptr(gy), ptr(ckpt),
        ptr(ddt), ptr(du), ptr(dB), ptr(dC), ptr(dA), ptr(dD), ptr(scratch),
        Bn, S, d_in, n, chunk, DTYPES[u.dtype], DTYPES[scan_dtype],
        stream_of(dt)))
    return ddt, du, dB, dC, dA, dD
