"""Launchers of the uplink-compression CUDA kernels (``csrc/compress.cu``
and ``csrc/segment_ranks.cu``, which share ``csrc/key_hist.cuh``).

Replaces ``repro/kernels/compress/kernel.py``'s ``rank_select_2d``
(``_rank_select_kernel``, ``_select_k``), ``int8_2d`` (``_int8_kernel``)
and ``segment_ranks_2d`` (``_segment_ranks_kernel``), which share one
``pl.pallas_call``.  Bound by bytes: one read of ``(N, M)`` and one
write of the result; the source files' headers say what the radix-select,
counting-rank and radix-sort designs move on top of that.

The launcher lays the columns out for the kernels: small int64 device
arrays with each segment's range and static keep-count, and a chunk
table that cuts every segment and every gap between segments into
blocks of at most :data:`CHUNK` columns (one CUDA block per chunk and
row), or :data:`KEY_CHUNK` for the bf16 kernels, which keep a
32,768-bin histogram of every chunk (rank_select, segment_ranks) or a
32,768-entry code table in each block (int8).  Scratch (histograms,
per-(row, segment) state, tie counts) is allocated here and freed with
the call.
The library is compiled on the first launch
(:mod:`repro_torch.kernels.build`).
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
KEY_CHUNK = 1 << 20        # columns per bf16 key histogram (128 KB: ~6% of x)
KEY_GROUP_BYTES = 1 << 30  # the bf16 key histograms of one row group, at most
HIGH_BINS, LOW_BINS = 1 << 15, 1 << 16
ROWSEG_WORDS = 10          # int64 words of the kernels' RowSeg
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"topk": 0, "adaptive_topk": 1}
RANK_TILE = 4096           # positions per block of the float32 radix sort
RANK_GROUP_COLS = 1 << 28  # rows sorted together: at most this many columns
SCAN_CHUNK = 4096          # histogram entries per scan block


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_rank_select.argtypes = [PTR, PTR, I64, I64, INT, INT, INT,
                                      F64, PTR, PTR, PTR, PTR, PTR, I64,
                                      PTR, PTR, PTR, PTR, I64, PTR, PTR, PTR,
                                      PTR, PTR, PTR, PTR]
    lib.repro_rank_select.restype = INT
    lib.repro_int8_quantize.argtypes = [PTR, PTR, I64, I64, INT, INT, PTR, PTR,
                                        I64, PTR, PTR, PTR, PTR, I64, PTR, F32,
                                        F32, PTR]
    lib.repro_int8_quantize.restype = INT
    return lib


def chunk_table(segments: tuple, width: int, size: int = CHUNK) -> list:
    """``(lo, hi, segment or -1, first chunk of the interval)`` for every
    chunk of at most ``size`` columns of the segments and of the gaps
    between them, in column order; no chunk crosses an interval."""
    table = []
    for lo, hi, seg in column_intervals(segments, width):
        first = len(table)
        for c in range(lo, hi, size):
            table.append((c, min(c + size, hi), seg, first))
    return table


def key_chunks(segments: tuple, width: int, size: int = KEY_CHUNK) -> tuple:
    """The bf16 counting rank's layout, :func:`chunk_table` of ``size``
    columns: ``(chunks, intervals)``, each chunk ``(lo, hi, interval
    index, 0)`` and each interval ``(first chunk, chunk count)``, in
    column order."""
    table = chunk_table(segments, width, size)
    firsts = sorted({first for *_, first in table})
    index = {f: i for i, f in enumerate(firsts)}
    ends = firsts[1:] + [len(table)]
    return ([(lo, hi, index[first], 0) for lo, hi, _, first in table],
            [(f, e - f) for f, e in zip(firsts, ends)])


def _arr(vals, device) -> torch.Tensor:
    return torch.tensor(list(vals), dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=32)
def _layout(segments: tuple, width: int, device: torch.device,
            size: int = CHUNK) -> dict:
    """The device arrays of a column layout (cached per layout)."""
    table = chunk_table(segments, width, size)
    cols = list(zip(*table)) if table else [(), (), (), ()]
    seg_chunks = [[i for i, row in enumerate(table) if row[2] == j]
                  for j in range(len(segments))]
    return {"seg_lo": _arr((s0 for s0, _ in segments), device),
            "seg_hi": _arr((s1 for _, s1 in segments), device),
            "seg_first": _arr((c[0] for c in seg_chunks), device),
            "seg_count": _arr((len(c) for c in seg_chunks), device),
            "chunk_lo": _arr(cols[0], device),
            "chunk_hi": _arr(cols[1], device),
            "chunk_seg": _arr(cols[2], device),
            "chunk_first": _arr(cols[3], device),
            "n_segs": len(segments), "n_chunks": len(table)}


@functools.lru_cache(maxsize=32)
def _keep_counts(segments: tuple, ratio: float, device: torch.device):
    return torch.tensor([seg_k(ratio, s1 - s0) for s0, s1 in segments],
                        dtype=torch.int64, device=device)


def _prepare(name: str, x: torch.Tensor, segments: tuple, size: int = CHUNK):
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
    return out, vec, _layout(segments, m, x.device, size)


def rank_select(x: torch.Tensor, segments: tuple, mode: str, ratio: float,
                energy: float) -> torch.Tensor:
    """The rank-select kernel on a CUDA ``(N, M)`` buffer (bf16 with a
    histogram of every chunk of :data:`KEY_CHUNK` columns)."""
    bf16 = x.dtype == torch.bfloat16
    out, vec, lay = _prepare("rank_select", x, segments,
                             KEY_CHUNK if bf16 else CHUNK)
    n, m = x.shape
    if m == 0:
        return out
    dev, S, C = x.device, lay["n_segs"], lay["n_chunks"]

    def scratch(count, dtype=torch.int32):
        # float32's histograms and tie counts are accumulated; every bf16
        # scratch word is written before it is read
        return (torch.empty if bf16 else torch.zeros)(count, dtype=dtype,
                                                      device=dev)

    hist_hi = scratch(n * S * HIGH_BINS)   # bf16: the bin totals
    hist_lo = None if bf16 else scratch(n * S * LOW_BINS)
    energy_hi = (scratch(n * S * HIGH_BINS, torch.float64)
                 if not bf16 and mode == "adaptive_topk" else None)
    chunk_hist = scratch(n * C * HIGH_BINS) if bf16 else None
    ties = scratch(n * C)                  # bf16: the tie prefixes
    state = torch.zeros(n * S * ROWSEG_WORDS, dtype=torch.int64, device=dev)
    k = _keep_counts(segments, ratio, dev)
    check_launch("rank_select", _lib().repro_rank_select(
        ptr(x), ptr(out), n, m, DTYPES[x.dtype], vec, MODES[mode],
        float(energy), ptr(lay["seg_lo"]), ptr(lay["seg_hi"]), ptr(k),
        ptr(lay["seg_first"]), ptr(lay["seg_count"]), S,
        ptr(lay["chunk_lo"]), ptr(lay["chunk_hi"]), ptr(lay["chunk_seg"]),
        ptr(lay["chunk_first"]), C, ptr(hist_hi), ptr(hist_lo),
        ptr(energy_hi), ptr(chunk_hist), ptr(state), ptr(ties),
        stream_of(x)))
    return out


def int8_quantize(x: torch.Tensor, segments: tuple) -> torch.Tensor:
    """The int8 quantize-dequantize kernel on a CUDA ``(N, M)`` buffer
    (bf16 in chunks of :data:`KEY_CHUNK` columns, each building its
    segment's code table)."""
    out, vec, lay = _prepare("int8_quantize", x, segments,
                             KEY_CHUNK if x.dtype == torch.bfloat16 else CHUNK)
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
    lib.repro_segment_ranks_sort.argtypes = [PTR, PTR, I64, I64, PTR, I64,
                                             I64, PTR, PTR, PTR, PTR, PTR,
                                             PTR, PTR]
    lib.repro_segment_ranks_sort.restype = INT
    lib.repro_segment_ranks_count.argtypes = [PTR, PTR, I64, I64, INT, PTR,
                                              I64, PTR, I64, I64, PTR, PTR,
                                              PTR]
    lib.repro_segment_ranks_count.restype = INT
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


@functools.lru_cache(maxsize=32)
def _key_layout(segments: tuple, width: int, device: torch.device):
    chunks, intervals = key_chunks(segments, width)
    return (torch.tensor(chunks, dtype=torch.int64, device=device),
            torch.tensor(intervals, dtype=torch.int64, device=device))


def segment_ranks(x: torch.Tensor, segments: tuple) -> torch.Tensor:
    """The segment-ranks kernel on a CUDA ``(N, M)`` buffer: int32 ranks.
    bfloat16 is ranked by counting: rows in groups whose histograms (one
    a chunk of :data:`KEY_CHUNK` columns, one an interval) stay under
    :data:`KEY_GROUP_BYTES`.  float32 is sorted in groups of at most
    :data:`RANK_GROUP_COLS` columns, with two ``(group, M)`` key and
    column buffers and the digit histograms.  The scratch is freed with
    the call."""
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
    dev = x.device

    def scratch(count):
        return torch.empty(count, dtype=torch.int32, device=dev)

    # every scratch buffer stays referenced until the launch is queued
    if x.dtype == torch.bfloat16:
        chunks, intervals = _key_layout(segments, m, dev)
        n_chunks, n_ivs = chunks.shape[0], intervals.shape[0]
        group = max(1, min(n, KEY_GROUP_BYTES
                           // (4 * HIGH_BINS * (n_chunks + n_ivs))))
        hist = scratch(group * n_chunks * HIGH_BINS)
        tot = scratch(group * n_ivs * HIGH_BINS)
        check_launch("segment_ranks", _ranks_lib().repro_segment_ranks_count(
            ptr(x), ptr(out), n, m, int(x.data_ptr() % 16 == 0), ptr(chunks),
            n_chunks, ptr(intervals), n_ivs, group, ptr(hist), ptr(tot),
            stream_of(x)))
        return out
    tiles = _rank_layout(segments, m, dev)
    n_tiles = tiles.shape[0]
    group = max(1, min(n, RANK_GROUP_COLS // m))
    pairs = [scratch(group * m) for _ in range(4)]   # keys, columns, twice
    hist = scratch(group * n_tiles * 256)
    partial = scratch(group * -(-(n_tiles * 256) // SCAN_CHUNK))
    check_launch("segment_ranks", _ranks_lib().repro_segment_ranks_sort(
        ptr(x), ptr(out), n, m, ptr(tiles), n_tiles, group,
        *(ptr(t) for t in pairs), ptr(hist), ptr(partial), stream_of(x)))
    return out
