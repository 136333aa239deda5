"""Launchers of the uplink-compression CUDA kernels (``csrc/compress.cu``
and ``csrc/segment_ranks.cu``).

Replaces ``repro/kernels/compress/kernel.py``'s ``rank_select_2d``
(``_rank_select_kernel``, ``_select_k``), ``int8_2d`` (``_int8_kernel``)
and ``segment_ranks_2d`` (``_segment_ranks_kernel``), which share one
``pl.pallas_call``.  Bound by bytes: one read of ``(N, M)`` and one
write of the result; the source files' headers say what the radix-select
and radix-sort designs move on top of that.

The launcher lays the columns out for the kernels: small int64 device
arrays with each segment's range and static keep-count, and a chunk
table that cuts every segment and every gap between segments into
blocks of at most :data:`CHUNK` columns (one CUDA block per chunk and
row).  Scratch (histograms, per-(row, segment) state, tie counts) is
allocated here, zeroed, and freed with the call.  The library is
compiled on the first launch (:mod:`repro_torch.kernels.build`).
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (F32, F64, I64, INT, PTR,
                                       check_launch, check_operands, ptr,
                                       stream_of)
from repro_torch.kernels.compress.ref import (INV_127, column_intervals,
                                             seg_k)

SOURCE = Path(__file__).parent / "csrc" / "compress.cu"
RANKS_SOURCE = Path(__file__).parent / "csrc" / "segment_ranks.cu"

CHUNK = 1 << 21            # columns per CUDA block
HIGH_BINS, LOW_BINS = 1 << 15, 1 << 16
ROWSEG_WORDS = 10          # int64 words of the kernels' RowSeg
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"topk": 0, "adaptive_topk": 1}
RANK_TILE = 4096           # positions per block of the radix sort
RANK_GROUP_COLS = 1 << 28  # rows sorted together: at most this many columns
SCAN_CHUNK = 4096          # histogram entries per scan block


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_rank_select.argtypes = [PTR, PTR, I64, I64, INT, INT, INT,
                                      F64, PTR, PTR, PTR, I64,
                                      PTR, PTR, PTR, PTR, I64, PTR, PTR, PTR,
                                      PTR, PTR, PTR]
    lib.repro_rank_select.restype = INT
    lib.repro_int8_quantize.argtypes = [PTR, PTR, I64, I64, INT, INT, PTR, PTR,
                                        I64, PTR, PTR, PTR, PTR, I64, PTR, F32,
                                        F32, PTR]
    lib.repro_int8_quantize.restype = INT
    return lib


def chunk_table(segments: tuple, width: int) -> list:
    """``(lo, hi, segment or -1, first chunk of the segment)`` for every
    chunk of the segments and of the gaps between them, in column order."""
    table = []
    for lo, hi, seg in column_intervals(segments, width):
        first = len(table)
        for c in range(lo, hi, CHUNK):
            table.append((c, min(c + CHUNK, hi), seg, first))
    return table


@functools.lru_cache(maxsize=32)
def _layout(segments: tuple, width: int, device: torch.device) -> dict:
    """The device arrays of a column layout (cached per layout)."""
    def arr(vals):
        return torch.tensor(list(vals), dtype=torch.int64, device=device)

    table = chunk_table(segments, width)
    cols = list(zip(*table)) if table else [(), (), (), ()]
    return {"seg_lo": arr(s0 for s0, _ in segments),
            "seg_hi": arr(s1 for _, s1 in segments),
            "chunk_lo": arr(cols[0]), "chunk_hi": arr(cols[1]),
            "chunk_seg": arr(cols[2]), "chunk_first": arr(cols[3]),
            "n_segs": len(segments), "n_chunks": len(table)}


@functools.lru_cache(maxsize=32)
def _keep_counts(segments: tuple, ratio: float, device: torch.device):
    return torch.tensor([seg_k(ratio, s1 - s0) for s0, s1 in segments],
                        dtype=torch.int64, device=device)


def _prepare(name: str, x: torch.Tensor, segments: tuple):
    check_operands(name, x)
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    n, m = x.shape
    if n > 65535:
        raise ValueError(f"{name}: {n} rows exceed the grid's 65,535")
    if any(s1 - s0 >= 1 << 32 for s0, s1 in segments):
        raise ValueError(f"{name}: a segment of 2^32 columns or more")
    out = torch.empty_like(x)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    return out, vec, _layout(segments, m, x.device)


def rank_select(x: torch.Tensor, segments: tuple, mode: str, ratio: float,
                energy: float) -> torch.Tensor:
    """The rank-select kernel on a CUDA ``(N, M)`` buffer."""
    out, vec, lay = _prepare("rank_select", x, segments)
    n, m = x.shape
    if m == 0:
        return out
    dev, S, C = x.device, lay["n_segs"], lay["n_chunks"]
    fp32 = x.dtype == torch.float32
    hist_hi = torch.zeros(n * S * HIGH_BINS, dtype=torch.int32, device=dev)
    hist_lo = (torch.zeros(n * S * LOW_BINS, dtype=torch.int32, device=dev)
               if fp32 else None)
    energy_hi = (torch.zeros(n * S * HIGH_BINS, dtype=torch.float64,
                             device=dev)
                 if fp32 and mode == "adaptive_topk" else None)
    state = torch.zeros(n * S * ROWSEG_WORDS, dtype=torch.int64, device=dev)
    ties = torch.zeros(n * C, dtype=torch.int32, device=dev)
    k = _keep_counts(segments, ratio, dev)
    check_launch("rank_select", _lib().repro_rank_select(
        ptr(x), ptr(out), n, m, DTYPES[x.dtype], vec, MODES[mode],
        float(energy), ptr(lay["seg_lo"]), ptr(lay["seg_hi"]), ptr(k), S,
        ptr(lay["chunk_lo"]), ptr(lay["chunk_hi"]), ptr(lay["chunk_seg"]),
        ptr(lay["chunk_first"]), C, ptr(hist_hi), ptr(hist_lo),
        ptr(energy_hi), ptr(state), ptr(ties), stream_of(x)))
    return out


def int8_quantize(x: torch.Tensor, segments: tuple) -> torch.Tensor:
    """The int8 quantize-dequantize kernel on a CUDA ``(N, M)`` buffer."""
    out, vec, lay = _prepare("int8_quantize", x, segments)
    n, m = x.shape
    if m == 0:
        return out
    amax = torch.zeros(n * lay["n_segs"], dtype=torch.int32, device=x.device)
    floor = torch.tensor(1e-12, dtype=x.dtype).float().item()
    check_launch("int8_quantize", _lib().repro_int8_quantize(
        ptr(x), ptr(out), n, m, DTYPES[x.dtype], vec, ptr(lay["seg_lo"]),
        ptr(lay["seg_hi"]), lay["n_segs"], ptr(lay["chunk_lo"]),
        ptr(lay["chunk_hi"]), ptr(lay["chunk_seg"]), ptr(lay["chunk_first"]),
        lay["n_chunks"], ptr(amax), INV_127, floor, stream_of(x)))
    return out


@functools.cache
def _ranks_lib():
    lib = build.load(RANKS_SOURCE)
    lib.repro_segment_ranks.argtypes = [PTR, PTR, I64, I64, INT, PTR, I64, I64,
                                        PTR, PTR, PTR, PTR, PTR, PTR, PTR]
    lib.repro_segment_ranks.restype = INT
    return lib


def rank_tiles(segments: tuple, width: int) -> list:
    """``(lo, hi, first, count)`` for every tile of at most
    :data:`RANK_TILE` columns of every column interval (segments and gaps,
    in column order): the interval's tiles are ``[first, first + count)``."""
    table = []
    for lo, hi, _ in column_intervals(segments, width):
        first = len(table)
        count = -(-(hi - lo) // RANK_TILE)
        table.extend((c, min(c + RANK_TILE, hi), first, count)
                     for c in range(lo, hi, RANK_TILE))
    return table


@functools.lru_cache(maxsize=32)
def _rank_layout(segments: tuple, width: int, device: torch.device):
    return torch.tensor(rank_tiles(segments, width), dtype=torch.int64,
                        device=device)


def segment_ranks(x: torch.Tensor, segments: tuple) -> torch.Tensor:
    """The segment-ranks kernel on a CUDA ``(N, M)`` buffer: int32 ranks.
    Rows are sorted in groups of at most :data:`RANK_GROUP_COLS` columns;
    the scratch (two ``(group, M)`` key and column buffers for float32,
    one for bfloat16, and the digit histograms) is freed with the call."""
    check_operands("segment_ranks", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"segment_ranks: the kernel takes float32 or "
                        f"bfloat16, not {x.dtype}")
    n, m = x.shape
    if n > 65535:
        raise ValueError(f"segment_ranks: {n} rows exceed the grid's 65,535")
    if m >= 1 << 31:
        raise ValueError("segment_ranks: a row of 2^31 columns or more")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if n == 0 or m == 0:
        return out
    tiles = _rank_layout(segments, m, x.device)
    n_tiles = tiles.shape[0]
    group = max(1, min(n, RANK_GROUP_COLS // m))
    dev = x.device

    def scratch(count):
        return torch.empty(count, dtype=torch.int32, device=dev)

    key_a, col_a = scratch(group * m), scratch(group * m)
    fp32 = x.dtype == torch.float32
    key_b, col_b = ((scratch(group * m), scratch(group * m)) if fp32
                    else (None, None))
    hist = scratch(group * n_tiles * 256)
    partial = scratch(group * -(-(n_tiles * 256) // SCAN_CHUNK))
    check_launch("segment_ranks", _ranks_lib().repro_segment_ranks(
        ptr(x), ptr(out), n, m, DTYPES[x.dtype], ptr(tiles), n_tiles, group,
        ptr(key_a), ptr(col_a), ptr(key_b), ptr(col_b), ptr(hist),
        ptr(partial), stream_of(x)))
    return out
