"""The port's uplink compressors against the reference's, on the CPU.

``repro_torch.kernels.compress.ops`` on a CPU tensor runs the plain
versions (``ref.py``), which the CUDA kernels are held to bit for bit on
the card.  Here they, and the port's registry compressors, are held to
the reference's fused ops in interpret mode and to its registry
functions on the same numpy inputs: float32 and bfloat16, one segment and
several with gap columns, ragged widths, tie-heavy, all-equal and
all-zero rows.  Top-k masks and int8 codes are discrete: equality is
exact.

``adaptive_topk`` sums the energy in float64 where the reference sums in
the buffer dtype, so it is held to exact equality on the segments whose
energy threshold lies farther than 1e-4 of the total (float32) or 1%
(bfloat16) from every prefix sum; the test computes that margin on its
own data and requires enough segments to pass it.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import compress as jcompress
from repro.kernels.compress import ops as jops
from repro_torch import kernels
from repro_torch.fed import api as tapi
from repro_torch.kernels import build
from repro_torch.fed import compress as tcompress
from repro_torch.fed import engine as tengine
from repro_torch.kernels.compress import kernel as tkernel
from repro_torch.kernels.compress import ops as tops
from repro_torch.kernels.compress import ref as tref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


class Cfg:
    """Duck-typed round config for the registry functions."""

    def __init__(self, name="topk", ratio=0.25, energy=0.95, backend="torch"):
        self.compression = name
        self.compress_ratio = ratio
        self.compress_energy = energy
        self.compress_backend = backend


def _data(kind, n, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "randn":
        return rng.normal(size=(n, m)).astype(np.float32)
    x = rng.choice(np.array([-1, -0.5, 0, 0.5, 1], np.float32), size=(n, m))
    x[1] = 0.5                      # all equal
    x[2] = 0.0                      # all zero
    return x


def _segments(multi, m):
    return ((0, 300), (310, 700), (700, m - 5)) if multi else None


def _pair(x, dt):
    jdt, tdt = DTYPES[dt]
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    return jx, tx


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_registry(name, jx, segs, **cfg):
    """The reference's registry compressor, segment by segment (jitted:
    the reference compares its int8 path jit against jit)."""
    fn = jax.jit(lambda a: jcompress.get_compressor(name)(a, Cfg(name, **cfg)))
    segs = segs or ((0, jx.shape[1]),)
    out = np.zeros(jx.shape, np.float32)
    for s0, s1 in segs:
        out[:, s0:s1] = _np(fn(jx[:, s0:s1]))
    return out


def _port_registry(name, tx, segs, **cfg):
    segs = segs or ((0, tx.shape[1]),)
    out = np.zeros(tx.shape, np.float32)
    for s0, s1 in segs:
        out[:, s0:s1] = _np(tcompress.get_compressor(name)(
            tx[:, s0:s1], Cfg(name, **cfg)))
    return out


CASES = [(dt, kind, multi) for dt in DTYPES for kind in ("randn", "ties")
         for multi in (False, True)]


@pytest.mark.parametrize("dt,kind,multi", CASES,
                         ids=[f"{d}-{k}-{'segs' if s else 'one'}"
                              for d, k, s in CASES])
def test_topk_matches_reference_exactly(dt, kind, multi):
    m = 1000 if multi else 1001
    jx, tx = _pair(_data(kind, 3, m, seed=len(dt) + 7 * multi), dt)
    segs = _segments(multi, m)
    for ratio in (0.01, 0.25, 1.0):
        want = _np(jops.rank_select(jx, segments=segs, mode="topk",
                                    ratio=ratio, interpret=True))
        got = tops.rank_select(tx, segments=segs, mode="topk", ratio=ratio)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(
            _port_registry("topk", tx, segs, ratio=ratio),
            _jax_registry("topk", jx, segs, ratio=ratio))
        kept = (_np(got) != 0).sum(axis=1)
        if kind == "randn":         # exactly k per (row, segment)
            ks = [tref.seg_k(ratio, s1 - s0)
                  for s0, s1 in (segs or ((0, m),))]
            assert (kept == sum(ks)).all()


@pytest.mark.parametrize("dt,kind,multi", CASES,
                         ids=[f"{d}-{k}-{'segs' if s else 'one'}"
                              for d, k, s in CASES])
def test_int8_matches_reference_exactly(dt, kind, multi):
    m = 1000 if multi else 1001
    x = _data(kind, 3, m, seed=3 + multi)
    if kind == "randn":
        x *= np.exp(np.random.default_rng(5).normal(size=x.shape) * 2)
    jx, tx = _pair(x.astype(np.float32), dt)
    segs = _segments(multi, m)
    want = _np(jops.int8_quantize(jx, segments=segs, interpret=True))
    got = tops.int8_quantize(tx, segments=segs)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_port_registry("int8", tx, segs),
                                  _jax_registry("int8", jx, segs))


def _hot_rows(n, m, seed):
    """Rows with a few dominant entries (exact in bf16) over small noise:
    the energy crossings sit far from the neighbouring prefix sums."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) * 1e-3).astype(np.float32)
    for i in range(n):
        hot = rng.choice(m, size=rng.integers(2, 12), replace=False)
        mags = 2.0 ** rng.integers(-2, 4, size=hot.size) * rng.choice(
            [1.0, 1.5], size=hot.size)
        x[i, hot] = mags * rng.choice([-1.0, 1.0], size=hot.size)
    return x


def _margin(seg_np, dt, energy):
    """min_j |cum_j - energy * total| / total of one segment row, with the
    squares rounded to the buffer dtype and summed in float64."""
    _, tdt = DTYPES[dt]
    mag = torch.from_numpy(np.abs(seg_np)).to(tdt)
    sq = (mag * mag).double().numpy()
    cum = np.cumsum(np.sort(sq)[::-1])
    total = max(cum[-1], 1e-30)
    return np.abs(cum - energy * total).min() / total


# randn segments of a few hundred entries have prefix sums about 1/300 of
# the total apart: enough margin in float32, never 1% in bfloat16
@pytest.mark.parametrize("dt,data", [("f32", "randn"), ("f32", "hot"),
                                     ("bf16", "hot")])
def test_adaptive_topk_matches_reference_where_the_threshold_has_margin(
        dt, data):
    tol = {"f32": 1e-4, "bf16": 1e-2}[dt]
    m = 1000
    x = (_data("randn", 4, m, seed=11) if data == "randn"
         else _hot_rows(4, m, seed=12))
    jx, tx = _pair(x, dt)
    segs = ((0, 300), (310, 700), (700, m - 5))
    checked = 0
    for ratio, energy in ((0.001, 0.5), (0.001, 0.8), (0.001, 0.95),
                          (0.25, 0.5), (0.25, 0.95)):
        kw = dict(mode="adaptive_topk", ratio=ratio, energy=energy)
        want = _np(jops.rank_select(jx, segments=segs, interpret=True, **kw))
        got = _np(tops.rank_select(tx, segments=segs, **kw))
        jreg = _jax_registry("adaptive_topk", jx, segs, ratio=ratio,
                             energy=energy)
        treg = _port_registry("adaptive_topk", tx, segs, ratio=ratio,
                              energy=energy)
        np.testing.assert_array_equal(treg, got)
        for i in range(x.shape[0]):
            for s0, s1 in segs:
                if _margin(_np(tx)[i, s0:s1], dt, energy) <= tol:
                    continue
                np.testing.assert_array_equal(got[i, s0:s1], want[i, s0:s1])
                np.testing.assert_array_equal(got[i, s0:s1], jreg[i, s0:s1])
                checked += 1
    assert checked >= 20, f"only {checked} segments had the margin"


def test_adaptive_topk_keeps_everything_of_an_all_zero_row():
    x = torch.zeros((2, 50))
    x[0, 3] = 2.0
    out = tops.rank_select(x, mode="adaptive_topk", ratio=0.1, energy=0.9)
    assert torch.equal(out, x)


# Segment sets over a width of 257: an interior and a trailing gap; a
# leading gap, interior gaps and a trailing gap; one segment; none.  The
# reference ranks every gap within itself, so the whole width is compared.
RANK_SEGMENTS = (((0, 100), (120, 250)),
                 ((5, 60), (64, 134), (140, 200), (210, 250)),
                 ((3, 257),), None)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_segment_ranks_oracle_matches_reference(dt):
    x = _data("ties", 3, 257, seed=4)
    x[0] = np.random.default_rng(4).normal(size=257)
    jx, tx = _pair(x, dt)
    for segs in RANK_SEGMENTS:
        want = np.asarray(jops.segment_ranks(jx, segments=segs,
                                             interpret=True))
        got = tref.segment_ranks_ref(tx, segs).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"segments {segs}")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_segment_ranks_op_equals_the_reference_op(dt):
    """The port's public op (plain version on the CPU) against the
    reference's public op in interpret mode, edge values included: ties,
    +-0.0, +-inf and a NaN (its key ranks above inf's)."""
    x = _data("ties", 5, 300, seed=6)
    x[3, ::7] = -0.0
    x[4, :4] = (np.inf, -np.inf, np.nan, 0.0)
    jdt, tdt = DTYPES[dt]
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    segs = ((2, 90), (90, 180), (200, 290))
    want = np.asarray(jops.segment_ranks(jx, segments=segs, interpret=True))
    got = tops.segment_ranks(tx, segments=segs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the NaN leads its segment; +inf and -inf tie in the leading gap
    assert got[4, 2] == 0 and got[4, :2].tolist() == [0, 1]


def test_segment_ranks_rejects_what_the_reference_rejects():
    x = torch.randn(3, 40)
    with pytest.raises(ValueError, match="float64"):
        tops.segment_ranks(x.double())
    with pytest.raises(ValueError, match=r"\(N, M\)"):
        tops.segment_ranks(x[0])
    with pytest.raises(ValueError, match="sorted and disjoint"):
        tops.segment_ranks(x, segments=((10, 20), (15, 30)))
    with pytest.raises(ValueError, match="out of range"):
        tops.segment_ranks(x, segments=((0, 41),))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.segment_ranks(x, ((0, 40),))


def test_rank_tiles_cover_every_interval_in_order():
    T = tkernel.RANK_TILE
    segs = ((3, 10), (10, 10 + 2 * T + 5), (10 + 2 * T + 9, 10 + 2 * T + 20))
    width = segs[-1][1] + 7
    tiles = tkernel.rank_tiles(segs, width)
    cursor = 0
    for t, (lo, hi, first, count) in enumerate(tiles):
        assert lo == cursor and 0 < hi - lo <= T
        assert first <= t < first + count
        assert tiles[first][0] <= lo and tiles[first + count - 1][1] >= hi
        cursor = hi
    assert cursor == width
    starts = sorted({tiles[f][0] for _, _, f, _ in tiles})
    assert starts == [0, 3, 10, 10 + 2 * T + 5, 10 + 2 * T + 9, segs[-1][1]]
    assert [c for _, _, f, c in tiles if f == 2][0] == 3


def test_ops_reject_what_the_reference_rejects():
    x = torch.randn(3, 40)
    with pytest.raises(ValueError, match="float64"):
        tops.rank_select(x.double())
    with pytest.raises(ValueError, match=r"\(N, M\)"):
        tops.int8_quantize(x[0])
    with pytest.raises(ValueError, match="sorted and disjoint"):
        tops.rank_select(x, segments=((10, 20), (15, 30)))
    with pytest.raises(ValueError, match="out of range"):
        tops.int8_quantize(x, segments=((0, 41),))
    with pytest.raises(ValueError, match="mode"):
        tops.rank_select(x, mode="bottomk")


def test_cpu_ops_count_no_launch_and_launchers_reject_cpu_tensors():
    kernels.reset_launch_counts()
    x = torch.randn(3, 64)
    tops.rank_select(x)
    tops.int8_quantize(x)
    assert kernels.launch_counts()["rank_select"] == 0
    assert kernels.launch_counts()["int8_quantize"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.rank_select(x, ((0, 64),), "topk", 0.25, 0.95)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.int8_quantize(x, ((0, 64),))


def test_chunk_table_covers_segments_and_gaps_in_order():
    segs = ((3, 10), (10, 10 + 2 * tkernel.CHUNK + 5), (10 + 2 * tkernel.CHUNK + 9,
                                                        10 + 2 * tkernel.CHUNK + 20))
    width = segs[-1][1] + 7
    table = tkernel.chunk_table(segs, width)
    assert table[0] == (0, 3, -1, 0)
    cursor = 0
    for lo, hi, seg, first in table:
        assert lo == cursor and hi - lo <= tkernel.CHUNK
        assert table[first][2] == seg and table[first][0] <= lo
        if seg >= 0:
            assert segs[seg][0] <= lo and hi <= segs[seg][1]
        cursor = hi
    assert cursor == width
    assert [t[2] for t in table].count(1) == 3


def test_key_chunks_cover_every_interval_in_order():
    """The bf16 kernels' chunk table: every column once, in column order,
    no chunk across an interval edge; each interval's chunks in order."""
    C = tkernel.KEY_CHUNK
    segs = ((3, 10), (10, 10 + 2 * C + 5), (10 + 2 * C + 9, 10 + 2 * C + 20))
    width = segs[-1][1] + 7
    chunks, intervals = tkernel.key_chunks(segs, width)
    edges = tref.column_intervals(segs, width)
    assert len(intervals) == len(edges) == 6
    cursor = 0
    for i, (lo, hi, iv, pad) in enumerate(chunks):
        first, count = intervals[iv]
        assert lo == cursor and 0 < hi - lo <= C and pad == 0
        assert first <= i < first + count
        assert edges[iv][0] <= lo and hi <= edges[iv][1]
        cursor = hi
    assert cursor == width
    assert [c for _, c in intervals] == [1, 1, 3, 1, 1, 1]
    assert [f for f, _ in intervals] == [0, 1, 2, 5, 6, 7]
    assert sum(c for _, c in intervals) == len(chunks)


# ---------------------------------------------------------------------------
# The bf16 kernels' decomposition, emulated in plain PyTorch: the counting
# rank of csrc/segment_ranks.cu and rank_select's tie prefix from H[c][T]
# (csrc/compress.cu), step by step at small chunk and tile sizes
# ---------------------------------------------------------------------------

BINS = 1 << 15
NO_BIN = 0x8000


def _bins(x):
    """The 15-bit magnitude bin of a bf16 buffer: the float32 key >> 16."""
    b = (x.view(torch.int16).to(torch.int32) & 0x7FFF).long()
    assert torch.equal(b, (tref.magnitude_key(x) >> 16).long())
    return b


def _key_rows(n=5, m=300, seed=9):
    """Rows: randn with +-0.0, +-inf and NaN; randn rounded (tie runs);
    all equal; all zero; small values with a run of 2.0 over cols 20-199,
    across the edges of every chunk size below."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x[0, ::13] = np.resize([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0],
                           x[0, ::13].shape)
    x[1] = np.round(x[1] * 3)
    x[2] = -0.75
    x[3] = 0.0
    x[4] *= 0.1
    x[4, 20:200] = 2.0
    return torch.from_numpy(x).to(torch.bfloat16)


KEY_SEGMENTS = ((3, 140), (150, 290))      # gaps before, between, after


def _chunk_hist(b, lo, hi):
    return torch.bincount(b[lo:hi], minlength=BINS)


def _counting_ranks(x, segments, chunk, tile=4, pos_bits=2):
    """segment_ranks' bf16 counting rank: per-chunk histograms; bases =
    #(keys of the interval above the bin) + the bin's count in the
    interval's earlier chunks; then each tile of the chunk sorted by
    (bin << pos_bits | position) in two stable LSD passes of 8-bit digits,
    each bin's run ranked from the running base, which the run's last entry
    advances."""
    n, m = x.shape
    out = torch.full((n, m), -1, dtype=torch.int64)
    chunks, intervals = tkernel.key_chunks(segments, m, chunk)
    pos = torch.arange(tile)
    for r in range(n):
        b = _bins(x[r])
        H = torch.stack([_chunk_hist(b, lo, hi) for lo, hi, _, _ in chunks])
        for first, count in intervals:
            hi_ = H[first:first + count]
            tot = hi_.sum(0)
            above = tot.flip(0).cumsum(0).flip(0) - tot
            before = hi_.cumsum(0) - hi_
            for c in range(first, first + count):
                lo, hi, _, _ = chunks[c]
                base = before[c - first] + above
                for t0 in range(lo, hi, tile):
                    cols = t0 + pos
                    ok = cols < hi
                    v = torch.where(ok, b[cols.clamp(max=m - 1)], NO_BIN)
                    v = v << pos_bits | pos
                    for shift in (pos_bits, pos_bits + 8):
                        digit = (v >> shift) & 0xFF
                        v = v[torch.sort(digit, stable=True).indices]
                    key = v >> pos_bits
                    s = torch.arange(tile)
                    change = key[1:] != key[:-1]
                    opens = torch.cat([torch.tensor([True]), change])
                    closes = torch.cat([change, torch.tensor([True])])
                    valid = key != NO_BIN
                    o = opens & valid
                    base[key[o]] -= s[o]
                    rank = base[key.clamp(max=BINS - 1)] + s
                    out[r, t0 + (v & (tile - 1))[valid]] = rank[valid]
                    e = closes & valid
                    base[key[e]] += s[e] + 1
    assert bool((out >= 0).all())
    return out.to(torch.int32)


def _square(b, dtype):
    """The kernel's square_of: |x| squared in float32, rounded to the
    buffer dtype, as a float64."""
    v = torch.tensor([b << 16], dtype=torch.int32).view(torch.float32)
    return float((v * v).to(dtype).double())


def _adaptive_k(tot, dtype, k_floor, m, energy):
    """select_exact_kernel's float64 walk over the bins from the top."""
    nz = [int(i) for i in torch.nonzero(tot).flatten().flip(0)]
    total = 0.0
    for b in nz:
        total += float(tot[b]) * _square(b, dtype)
    thr = energy * max(total, 1e-30)
    s, below = 0.0, 0
    for b in nz:
        c, e = int(tot[b]), _square(b, dtype)
        if s + c * e < thr:
            s += c * e
            below += c
            continue
        lo, hi = 0, c           # the largest j in [0, c] with s + j e < thr
        while lo < hi and e != 0.0:
            mid = lo + (hi - lo + 1) // 2
            if s + mid * e < thr:
                lo = mid
            else:
                hi = mid - 1
        below += c if e == 0.0 else lo
        break
    return min(max(1 + below, k_floor), m)


def _select_from_hists(x, segments, chunk, mode, ratio, energy):
    """rank_select on bf16 from the chunk histograms: T, #above and #ties
    from the segment's bin totals; each chunk's tie prefix from H[c][T];
    a chunk keeps all its ties or none unless the kept ties end in it, and
    only there are ties ranked in column order."""
    n, m = x.shape
    table = tkernel.chunk_table(segments, m, chunk)
    out = torch.zeros_like(x)
    for r in range(n):
        b = _bins(x[r])
        for j, (s0, s1) in enumerate(segments):
            spans = [(lo, hi) for lo, hi, seg, _ in table if seg == j]
            H = torch.stack([_chunk_hist(b, lo, hi) for lo, hi in spans])
            tot = H.sum(0)
            k = tref.seg_k(ratio, s1 - s0)
            if mode == "adaptive_topk":
                k = _adaptive_k(tot, x.dtype, k, s1 - s0, energy)
            at_least = tot.flip(0).cumsum(0)   # entries in bins >= b, top first
            t = BINS - 1 - int(torch.nonzero(at_least >= k)[0])
            ties = int(tot[t])
            need = k - (int(at_least[BINS - 1 - t]) - ties)
            ranks_ties = 0 < need < ties
            tie_pre = (H[:, t].cumsum(0) - H[:, t]).tolist()
            for (lo, hi), pre, here in zip(spans, tie_pre, H[:, t].tolist()):
                keep_ties, cut = need >= ties, False
                if ranks_ties:
                    keep_ties = pre + here <= need
                    cut = pre < need < pre + here
                tie = b[lo:hi] == t
                keep = (b[lo:hi] > t) | (tie & keep_ties)
                if cut:
                    keep |= tie & (pre + tie.cumsum(0) - 1 < need)
                out[r, lo:hi] = torch.where(keep, x[r, lo:hi],
                                            torch.zeros_like(x[r, lo:hi]))
    return out


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_counting_rank_decomposition_matches_the_plain_ranks(chunk):
    x = _key_rows()
    for segs in (KEY_SEGMENTS, ((0, 300),)):
        want = tref.segment_ranks_ref(x, segs)
        assert torch.equal(_counting_ranks(x, segs, chunk), want), segs
    # and the plain ranks are the reference's (interpret mode)
    if chunk == 7:
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        np.testing.assert_array_equal(
            np.asarray(jops.segment_ranks(jx, segments=KEY_SEGMENTS,
                                          interpret=True)),
            tref.segment_ranks_ref(x, KEY_SEGMENTS).numpy())


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_rank_select_tie_prefix_decomposition_matches_the_plain_version(
        chunk):
    x = _key_rows(seed=10)
    for ratio in (0.01, 0.25, 0.5, 1.0):
        want = tref.rank_select_ref(x, KEY_SEGMENTS, "topk", ratio)
        got = _select_from_hists(x, KEY_SEGMENTS, chunk, "topk", ratio, 0.95)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    hot = torch.from_numpy(_hot_rows(4, 300, seed=13)).to(torch.bfloat16)
    checked = 0
    for ratio, energy in ((0.001, 0.5), (0.001, 0.95), (0.25, 0.8)):
        want = tref.rank_select_ref(hot, KEY_SEGMENTS, "adaptive_topk", ratio,
                                    energy)
        got = _select_from_hists(hot, KEY_SEGMENTS, chunk, "adaptive_topk",
                                 ratio, energy)
        for i in range(hot.shape[0]):
            for s0, s1 in KEY_SEGMENTS:
                if _margin(hot.float().numpy()[i, s0:s1], "bf16",
                           energy) <= 1e-2:
                    continue
                assert torch.equal(got[i, s0:s1].view(torch.int16),
                                   want[i, s0:s1].view(torch.int16))
                checked += 1
    assert checked >= 12, f"only {checked} segments had the margin"
    if chunk == 7:     # the plain version is the reference's (interpret mode)
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        np.testing.assert_array_equal(
            _np(jops.rank_select(jx, segments=KEY_SEGMENTS, mode="topk",
                                 ratio=0.25, interpret=True)),
            _np(tref.rank_select_ref(x, KEY_SEGMENTS, "topk", 0.25)))


# int8's bf16 code table (csrc/compress.cu quantize_kernel_table), emulated:
# the maxima of chip_smoke.py's all-patterns row (Queue C's float32 amax
# 1218.9414 is 1216 in bf16; 1e-11 floors the scale at 1e-12; at 0.171875
# the maximum's own quotient rounds to 128, so -0.171875 saturates at -128)
INT8_MAXIMA = {"1.0": 1.0, "1218.9414": 1218.9414, "1e-11": 1e-11,
               "largest-finite": float(torch.finfo(torch.bfloat16).max),
               "all-zero": 0.0, "0.171875": 0.171875}
SATURATES = 0.171875


def _finite_patterns(top):
    """Every finite bf16 pattern of magnitude at most bf16(top), shuffled:
    a (1, m) row."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    finite = every[torch.isfinite(every)]
    row = finite[finite.abs() <= torch.tensor(top, dtype=torch.bfloat16)]
    gen = torch.Generator().manual_seed(0)
    return row[torch.randperm(row.numel(), generator=gen)][None]


def _int8_by_code_table(x):
    """The kernel's design on one (1, m) bf16 segment: the scale from the
    largest |x| pattern; the code of every pattern up to it with
    ``int8_ref``'s operations, saturated at 128; then, per entry, the sign
    before the clamp (``-code`` for a negative x, ``min(code, 127)``
    otherwise, an integer) and ``bf16(q * scale)``."""
    bits = x.view(torch.int16).to(torch.int32)
    mag = bits & 0x7FFF
    top = int(mag.max())
    scale = torch.tensor([[top << 16]], dtype=torch.int32).view(torch.float32)
    scale = (scale * tref.INV_127).to(torch.bfloat16)
    scale = torch.maximum(scale, torch.full_like(scale, 1e-12))
    p = torch.arange(top + 1, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)[None]
    code = torch.round(p / scale).clamp(max=128.0).to(torch.int32)[0]
    c = code[mag]
    q = torch.where(bits < 0, -c, c.clamp(max=127))
    return q.to(torch.bfloat16) * scale, q


@pytest.mark.parametrize("top", list(INT8_MAXIMA.values()),
                         ids=list(INT8_MAXIMA))
def test_int8_code_table_matches_the_plain_version_on_every_pattern(top):
    """Bit for bit (+0.0 and -0.0 apart) on every finite bf16 pattern under
    each maximum; the codes reach the sign-and-clamp order's edge cases."""
    x = _finite_patterns(top)
    got, q = _int8_by_code_table(x)
    want = tref.int8_ref(x)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the code 128: -128 for the negative maximum, 127 for the positive
    assert bool((q == -128).any()) == (top == SATURATES)
    # negative entries whose code is 0 (the +0.0 rule), where there are any
    small = (x < 0) & (want == 0)
    assert bool(small.any()) == (top > 0)
    assert not bool(torch.signbit(want[small]).any())


def test_library_path_covers_the_headers_beside_a_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    (tmp_path / "notes.txt").write_text("x")
    first = build.library_path(src)
    assert build.library_path(src) == first
    (tmp_path / "notes.txt").write_text("y")
    assert build.library_path(src) == first
    header.write_text("// two\n")
    second = build.library_path(src)
    assert second != first and second.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("")
    assert build.library_path(src) not in (first, second)
    assert tkernel.SOURCE.with_name("key_hist.cuh").exists()


# ---------------------------------------------------------------------------
# Increment compression: backends, packing, padding
# ---------------------------------------------------------------------------

def _gappy_tree(n=3, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((n, 7), generator=g, dtype=dtype),
            "b": torch.randn((n, 10, 10), generator=g, dtype=dtype),
            "c": torch.randn((n, 33), generator=g, dtype=dtype)}


@pytest.mark.parametrize("name", ["topk", "int8", "adaptive_topk"])
def test_backends_and_layouts_give_the_same_bits_and_zero_padding(name):
    tree = _gappy_tree()
    buf, meta = tcompress.pack_leaves(tree)
    assert meta.width > meta.m_total       # the layout has gap columns
    buf_dirty = buf.clone()
    gap = torch.ones(meta.width, dtype=torch.bool)
    for s0, s1 in meta.segments:
        gap[s0:s1] = False
    buf_dirty[:, gap] = 7.0
    outs = []
    for backend in ("torch", "fused", "auto"):
        cfg = Cfg(name, ratio=0.2, energy=0.9, backend=backend)
        q = tcompress.compress_increment_packed(buf_dirty, meta, cfg)
        assert torch.equal(q[:, gap], torch.zeros_like(q[:, gap]))
        outs.append(q)
        qt = tcompress.compress_increment(tree, cfg)
        assert torch.equal(tcompress.pack_leaves(qt, meta)[0], q)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("name", ["topk", "int8", "adaptive_topk"])
def test_packed_rounds_keep_t_padding_zero_and_match_tree_rounds(name):
    """Three compressed rounds of the engine with a toy local solver on a
    layout with gap columns: the packed and tree layouts agree bit for
    bit, t's padding stays zero, and an idle agent's t stays put."""
    tree = _gappy_tree(seed=1)
    meta = tcompress.packed_meta(tree)
    gap = torch.ones(meta.width, dtype=torch.bool)
    for s0, s1 in meta.segments:
        gap[s0:s1] = False

    def solver(x, v):
        return tengine.tree_map(lambda a, b: 0.6 * a + 0.5 * b, x, v), None

    rcfg = tengine.RoundConfig(n_agents=3, compression=name,
                               compress_ratio=0.3, compress_backend="fused",
                               engine_backend="fused", state_layout="packed")
    tcfg = dataclasses.replace(rcfg, state_layout="tree")
    x, z, t = (tcompress.pack_leaves(tree, meta)[0] for _ in range(3))
    xt, zt = tree, {k: v.clone() for k, v in tree.items()}
    tt = {k: v.clone() for k, v in tree.items()}
    for u in ([1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [0.0, 1.0, 1.0]):
        idle = u.index(0.0) if 0.0 in u else None
        t_idle = None if idle is None else t[idle].clone()
        res = tengine.packed_round_step(rcfg, meta, x, z, t, solver, u=u)
        rt = tengine.round_step(tcfg, xt, zt, tt, solver, u=u)
        x, z, t = res.x, res.z, res.t
        xt, zt, tt = rt.x, rt.z, rt.t
        assert torch.equal(t[:, gap], torch.zeros_like(t[:, gap]))
        assert idle is None or torch.equal(t[idle], t_idle)
        for var, tr in (("x", xt), ("z", zt), ("t", tt)):
            assert torch.equal(getattr(res, var),
                               tcompress.pack_leaves(tr, meta)[0]), var
    assert not torch.equal(t, z)


def test_resolve_backend_takes_the_kernel_wherever_one_exists():
    assert tcompress.resolve_backend(Cfg("topk", backend="auto")) == "fused"
    assert tcompress.resolve_backend(Cfg("int8", backend="auto")) == "fused"
    assert tcompress.resolve_backend(Cfg("none", backend="auto")) == "torch"
    assert tcompress.resolve_backend(Cfg("topk", backend="torch")) == "torch"
    with pytest.raises(ValueError, match="compress backend"):
        tcompress.resolve_backend(Cfg("topk", backend="pallas"))


def test_fedspec_cli_round_trip_with_compression_flags():
    spec = tapi.spec_from_args(["--compression", "adaptive_topk",
                                "--compress-ratio", "0.1",
                                "--compress-energy", "0.9",
                                "--compress-backend", "fused",
                                "--state-layout", "packed"])
    assert spec.compression == tapi.CompressionSpec(
        name="adaptive_topk", ratio=0.1, energy=0.9, backend="fused")
    rcfg = spec.validate().round_config()
    assert (rcfg.compression, rcfg.compress_ratio, rcfg.compress_energy,
            rcfg.compress_backend) == ("adaptive_topk", 0.1, 0.9, "fused")
    assert rcfg.compressed
    ap = argparse.ArgumentParser()
    tapi.add_spec_args(ap)
    with pytest.raises(SystemExit):
        ap.parse_args(["--compression", "sign"])
    with pytest.raises(SystemExit):
        ap.parse_args(["--compress-backend", "pallas"])


def test_unknown_compressor_and_backend_raise():
    with pytest.raises(ValueError, match="unknown compressor 'sign'"):
        tapi.FedSpec(n_agents=2, gamma=0.05,
                     compression=tapi.CompressionSpec(name="sign")).validate()
    with pytest.raises(ValueError, match="unknown compress backend"):
        tapi.FedSpec(n_agents=2, gamma=0.05, compression=tapi.CompressionSpec(
            name="topk", backend="xla")).validate()
    with pytest.raises(ValueError, match="unknown compressor"):
        tengine.RoundConfig(n_agents=2, compression="sign")
    with pytest.raises(ValueError, match="compress backend"):
        tengine.RoundConfig(n_agents=2, compression="topk",
                            compress_backend="pallas")


def test_registered_compressor_is_reachable_by_name():
    @tcompress.register_compressor("halve_test")
    def halve(dz, cfg):
        return dz * 0.5

    try:
        cfg = tengine.RoundConfig(n_agents=3, compression="halve_test",
                                  compress_backend="fused")
        tree = _gappy_tree()
        q = tcompress.compress_increment(tree, cfg)
        assert torch.equal(q["b"], tree["b"] * 0.5)
    finally:
        tcompress._REGISTRY.pop("halve_test")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py phase 2 is their full check)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_ranks_kernel_matches_plain_version_on_card(cuda_device,
                                                            dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((5, 5001), generator=gen, device=cuda_device).to(dtype)
    x[1] = x[1].round()             # ties
    x[2, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    for segs in (None, ((0, 300), (310, 4700), (4800, 4999))):
        kernels.reset_launch_counts()
        got = tops.segment_ranks(x, segments=segs)
        assert kernels.launch_counts()["segment_ranks"] == 1
        assert torch.equal(got.cpu(), tref.segment_ranks_ref(x.cpu(), segs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_kernels_match_plain_versions_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((3, 1001), generator=gen, device=cuda_device).to(dtype)
    segs = ((0, 300), (310, 700), (700, 996))
    for mode, energy in (("topk", 0.95), ("adaptive_topk", 0.5),
                         ("adaptive_topk", 0.95)):
        assert torch.equal(
            tops.rank_select(x, segments=segs, mode=mode, energy=energy),
            tref.rank_select_ref(x, segs, mode, 0.25, energy))
    assert torch.equal(tops.int8_quantize(x, segments=segs),
                       tref.int8_ref(x, segs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_over_several_chunks_match_plain_versions_on_card(
        cuda_device, dtype):
    """Both ranking kernels at a width over two chunks of either chunk
    table, with a tie run across the chunk edges that holds the topk cut,
    a rounded row and an all-zero row."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    m = 2 * tkernel.CHUNK + 4321
    x = torch.randn((4, m), generator=gen, device=cuda_device)
    x[1] = (x[1] * 3).round()
    x[2] = 0.0
    x[3] *= 0.1
    x[3, tkernel.KEY_CHUNK - 999:tkernel.KEY_CHUNK - 999 + m // 2] = 2.0
    x = x.to(dtype)
    segs = ((7, m // 3), (m // 3 + 5, m - 2))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for ratio in (0.01, 0.25):
        got = tops.rank_select(x, segments=segs, mode="topk", ratio=ratio)
        want = tref.rank_select_ref(x, segs, "topk", ratio)
        assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(tops.segment_ranks(x, segments=segs),
                       tref.segment_ranks_ref(x, segs))
