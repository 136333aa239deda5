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
Each lane group of G lanes walks a channel with K states a lane
(:func:`ssm_plan`); :func:`ssm_route_counts` tallies the launches of each
``(G, K)`` instantiation.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (I64, INT, PTR, check_launch,
                                       check_operands, ptr, stream_of)
from repro_torch.kernels.lru_scan.ref import SSM_BLOCK_CHANNELS, state_lanes

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
# ssm_mix_seq and ssm_mix_fused (repro/models/ssm.py:96, :123).  Operations
# bound both kernels: the forward's one exponential a state entry, the
# backward's 18 separately rounded float operations a state entry.
#
# Layout: a lane group of G lanes walks one channel (b, d) in time order,
# lane l holding the K = P / G states l, l + G, ... (P = n rounded up to a
# power of two), so the sum over states is the plain version's halving tree
# with its first log2 K levels in registers and its last log2 G levels as
# xor shuffles.  A block holds 64 channels of one batch row.  Time passes in
# tiles (32 steps forward, 8 backward) through a double-buffered ring in
# shared memory whose next tile's loads are in flight during the scan.  The
# forward checkpoints h every 8 steps; the backward rebuilds each 8-step
# sub-span's a in registers from its checkpoint (and h, in registers under
# a float32 scan, in shared memory under a bf16 one) and walks it back.
# The source file's header has the details.

SSM_SOURCE = Path(__file__).parent / "csrc" / "ssm_scan.cu"
SSM_MAX_STATE = 32          # kMaxN
SSM_CKPT_STEPS = 8          # kSub: steps between the forward's checkpoints
# the (G, K) instantiations in the library's route order, one for each P
SSM_ROUTES = ((1, 1), (1, 2), (1, 4), (2, 4), (4, 4), (8, 4))


def ssm_plan(n: int) -> tuple[int, int, int, int]:
    """``(G, K, channels, threads)`` of the kernels' blocks at state n: K
    = min(P, 4) states a lane, G = P / K lanes a channel, 64 channels and
    64 G threads a block.  Raises for a state out of range."""
    if not 1 <= n <= SSM_MAX_STATE:
        raise ValueError(f"ssm_scan: the kernel takes a state of 1 to "
                         f"{SSM_MAX_STATE}, not {n}")
    P = state_lanes(n)
    K = min(P, 4)
    G = P // K
    return G, K, SSM_BLOCK_CHANNELS, SSM_BLOCK_CHANNELS * G


def ssm_ckpt_shape(Bn: int, S: int, d_in: int, n: int) -> tuple:
    """The forward's checkpoints: h ahead of every 8-step sub-span, the P
    states of a channel in the lanes' order, (B, ceil(S / 8), d_in, P)."""
    return (Bn, -(-S // SSM_CKPT_STEPS), d_in, state_lanes(n))


@functools.cache
def _ssm_lib():
    lib = build.load(SSM_SOURCE)
    lib.repro_ssm_scan_fwd.argtypes = [PTR] * 8 + [I64] * 4 + [INT, INT, PTR]
    lib.repro_ssm_scan_fwd.restype = INT
    lib.repro_ssm_scan_bwd.argtypes = [PTR] * 15 + [I64] * 4 + [INT, INT, PTR]
    lib.repro_ssm_scan_bwd.restype = INT
    lib.repro_ssm_scan_plan.argtypes = [I64, PTR]
    lib.repro_ssm_scan_plan.restype = INT
    lib.repro_ssm_scan_ckpt_steps.argtypes = []
    lib.repro_ssm_scan_ckpt_steps.restype = INT
    lib.repro_ssm_scan_routes.argtypes = [PTR]
    lib.repro_ssm_scan_routes.restype = None
    return lib


def ssm_library_plan(n: int):
    """``(G, K, channels, threads)`` as the library plans state n (None
    where n is out of range); :func:`ssm_plan` mirrors it."""
    out = (ctypes.c_int * 5)()
    if _ssm_lib().repro_ssm_scan_plan(n, out) != 0:
        return None
    return tuple(out[:4])


def ssm_library_ckpt_steps() -> int:
    """The library's steps between checkpoints (:data:`SSM_CKPT_STEPS`)."""
    return _ssm_lib().repro_ssm_scan_ckpt_steps()


def ssm_route_counts() -> dict[str, dict[tuple[int, int], int]]:
    """Launches so far of each ``(G, K)`` instantiation, ``{"fwd": {(G,
    K): n}, "bwd": {...}}``, as the C launcher counts them where each
    launch succeeds."""
    out = (ctypes.c_int64 * (2 * len(SSM_ROUTES)))()
    _ssm_lib().repro_ssm_scan_routes(out)
    return {name: {gk: out[i * len(SSM_ROUTES) + r]
                   for r, gk in enumerate(SSM_ROUTES)}
            for i, name in enumerate(("fwd", "bwd"))}


def check_ssm(name, dt, u, Bm, Cm, A, D, scan_dtype, **more) -> None:
    """Raise unless dt (B, S, d_in) is a contiguous float32 CUDA tensor, u
    matches its shape (float32 or bfloat16), B and C are (B, S, n), A is
    (d_in, n) and D (d_in,), all float32, on dt's card and contiguous;
    1 <= n <= 32 and scan_dtype float32 or bfloat16; and ``more`` (name:
    (tensor, shape)) float32 of the shapes given."""
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
    if u.dtype not in DTYPES:
        raise TypeError(f"{name}: u must be float32 or bfloat16, not "
                        f"{u.dtype}")
    if not dt.is_cuda:
        raise ValueError(f"{name}: kernel operands must be CUDA tensors")
    card = dt.get_device()
    if u.shape != dt.shape or u.get_device() != card:
        raise ValueError(f"{name}: u is {tuple(u.shape)} on {u.device}, "
                         f"want {tuple(dt.shape)} on {dt.device}")
    if not (dt.is_contiguous() and u.is_contiguous()):
        raise ValueError(f"{name}: dt and u must be contiguous")
    f32 = torch.float32
    for key, t, shape in (("B", Bm, (Bn, S, n)), ("C", Cm, (Bn, S, n)),
                          ("A", A, (d_in, n)), ("D", D, (d_in,)),
                          *((k, t, sh) for k, (t, sh) in more.items())):
        if t.dtype != f32 or t.get_device() != card:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"want float32 on {dt.device}")
        if t.shape != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ssm_fwd(dt, u, Bm, Cm, A, D, scan_dtype=torch.float32):
    """``(y, ckpt)`` from the forward kernel: y (B, S, d_in) float32 and
    the float32 state ahead of every 8-step sub-span
    (:func:`ssm_ckpt_shape`), which the backward reads."""
    check_ssm("ssm_scan_fwd", dt, u, Bm, Cm, A, D, scan_dtype)
    Bn, S, d_in = dt.shape
    n = A.shape[1]
    y = torch.empty_like(dt)
    ckpt = dt.new_empty(ssm_ckpt_shape(Bn, S, d_in, n))
    if dt.numel() == 0:
        return y, ckpt
    check_launch("ssm_scan_fwd", _ssm_lib().repro_ssm_scan_fwd(
        ptr(dt), ptr(u), ptr(Bm), ptr(Cm), ptr(A), ptr(D), ptr(y), ptr(ckpt),
        Bn, S, d_in, n, DTYPES[u.dtype], DTYPES[scan_dtype], stream_of(dt)))
    return y, ckpt


def ssm_bwd(dt, u, Bm, Cm, A, D, ckpt, gy, scan_dtype=torch.float32):
    """``(ddt, du, dB, dC, dA, dD)``, float32, from the backward kernel and
    its fixed-order reduction, given the forward's ``ckpt`` and the
    upstream gradient ``gy`` of y."""
    Bn, S, d_in = dt.shape
    n = A.shape[1] if A.ndim == 2 else 0
    check_ssm("ssm_scan_bwd", dt, u, Bm, Cm, A, D, scan_dtype,
              gy=(gy, (Bn, S, d_in)),
              ckpt=(ckpt, ssm_ckpt_shape(Bn, S, d_in, n)))
    ddt, du = torch.empty_like(dt), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    if dt.numel() == 0:
        return ddt, du, dB.zero_(), dC.zero_(), dA.zero_(), dD.zero_()
    # the partial sums of dB, dC over the 64-channel blocks, of dA, dD over b
    scratch = dt.new_empty((2 * -(-d_in // SSM_BLOCK_CHANNELS) * Bn * S * n
                            + Bn * d_in * n + Bn * d_in,))
    check_launch("ssm_scan_bwd", _ssm_lib().repro_ssm_scan_bwd(
        ptr(dt), ptr(u), ptr(Bm), ptr(Cm), ptr(A), ptr(D), ptr(gy), ptr(ckpt),
        ptr(ddt), ptr(du), ptr(dB), ptr(dC), ptr(dA), ptr(dD), ptr(scratch),
        Bn, S, d_in, n, DTYPES[u.dtype], DTYPES[scan_dtype], stream_of(dt)))
    return ddt, du, dB, dC, dA, dD
