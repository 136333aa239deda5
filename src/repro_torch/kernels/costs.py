"""What each kernel launch costs: its operations and the HBM bytes it
must move, and a tally of both over the launches of a run.

The counts are the ones the kernels' bounds are priced from
(:mod:`repro_torch.launch.roofline` turns them into least times, and
``chip_smoke.py`` prints those bounds beside each kernel's time), so a
bound and a profiled round's report (:mod:`repro_torch.launch.profile_analysis`)
read one formula.  Bytes are each input read once and each output written
once; operations are counted as the kernel runs them (the bf16 flash
kernels multiply ``p`` and ``ds`` once per bf16 term), and depend on the
data where the work does (the flash masks' visible pairs).

Each ops wrapper calls :func:`record` where it counts its launch (on a
CUDA tensor; the plain versions on the CPU are aten ops, which
``torch.utils.flop_counter`` sees).  :func:`tally` reads the totals and
:func:`reset` clears them; :func:`repro_torch.kernels.reset_launch_counts`
clears them with the launch counts.
"""

from __future__ import annotations

import functools

# name -> [launches, flops, bytes]
_TALLY: dict = {}


def record(name: str, flops: float, nbytes: float) -> None:
    """Add one launch of kernel ``name`` with its operations and bytes."""
    rec = _TALLY.setdefault(name, [0, 0.0, 0.0])
    rec[0] += 1
    rec[1] += flops
    rec[2] += nbytes


def tally() -> dict:
    """``{name: {"launches", "flops", "bytes"}}`` since the last reset."""
    return {k: {"launches": v[0], "flops": v[1], "bytes": v[2]}
            for k, v in _TALLY.items()}


def reset() -> None:
    _TALLY.clear()


# ---------------------------------------------------------------------------
# The round edges and the update: (flops, bytes) of one launch on an
# (N, M) buffer of ``elt``-byte entries
# ---------------------------------------------------------------------------

def round_uplink(N: int, M: int, elt: int, lagged: bool) -> tuple:
    """Reads z (and t when lagged), writes v and the (1, M) y."""
    reads = N * M * (2 if lagged else 1)
    return 3 * N * M + 6 * M, (reads + N * M + M) * elt


def round_downlink(N: int, M: int, elt: int, lagged: bool) -> tuple:
    """Reads x, w, z (and t), the float32 (N,) row; writes x and z."""
    reads = 3 * N * M + (N * M if lagged else 0)
    return 5 * N * M + 6 * M, (reads + 2 * N * M) * elt + 4 * N


def round_uplink_partial(N: int, M: int, elt: int) -> tuple:
    """Reads one rank's rows, writes the (1, M) column sums."""
    return N * M, (N * M + M) * elt


def round_downlink_presummed(N: int, M: int, elt: int) -> tuple:
    """Reads x, w, z and the (1, M) y, the (N,) row; writes x and z."""
    return 3 * N * M, (5 * N * M + M) * elt + 4 * N


def fedplt_update(n: int, elt: int, noise: bool) -> tuple:
    """``n`` entries: reads w, g, v (and the noise t), writes w."""
    n_in = 4 if noise else 3
    return (5 + int(noise)) * n, (n_in + 1) * n * elt


# ---------------------------------------------------------------------------
# The compressors and the robust aggregate (bytes bound them)
# ---------------------------------------------------------------------------

def compress_rows(N: int, M: int, elt: int) -> tuple:
    """rank_select and int8_quantize: read x once, write q once."""
    return 0, 2 * N * M * elt


def segment_ranks(N: int, M: int, elt: int) -> tuple:
    """Read x once, write the int32 ranks."""
    return 0, N * M * elt + N * M * 4


def network_ops(n: int, m: int, dtype) -> float:
    """Integer min/max operations (two a compare-exchange) of the network
    the sort_aggregate kernel runs over ``m`` columns of ``n`` rows: the
    register route's bitonic network up to 32 rows; above, each thread's
    32 registers by Batcher's odd-even merge sort (191 compare-exchanges)
    and bitonic merges of sizes 64 ... P, log2(size) stages of P/2 each;
    a packed 16x2 operation of the bf16 lane routes counts once for its
    two columns."""
    pow2 = 1 << max(0, (n - 1).bit_length())
    lg = pow2.bit_length() - 1
    if pow2 <= 32:
        return 2 * m * pow2 * lg * (lg + 1) / 4
    ce = 191 * pow2 // 32 + sum(pow2 // 2 * s for s in range(6, lg + 1))
    packed = str(dtype).endswith("bfloat16")
    return 2 * m * ce / (2 if packed else 1)


def sort_aggregate(N: int, M: int, elt: int, dtype) -> tuple:
    """The network's operations and, a column, N selects, N - 1 adds and
    a multiply; reads the (N, M) rows, writes the (1, M) aggregate."""
    return network_ops(N, M, dtype) + 2 * N * M, (N * M + M) * elt


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, T: int, causal: bool, window) -> int:
    """The (query, key) pairs that the masks let through."""
    total = 0
    for qpos in range(S):
        lo = 0 if window is None else max(0, qpos - window + 1)
        hi = min(T - 1, qpos) if causal else T - 1
        total += max(0, hi - lo + 1)
    return total


def flash(B: int, S: int, H: int, Hkv: int, D: int, causal: bool, window,
          T=None, bf16: bool = True) -> dict:
    """``{"pairs", "fwd": {...}, "bwd": {...}}``: each pass's operations
    as the kernels run them -- ``q k^T`` and ``dO v^T`` once each
    (``flops_bf16``), ``p v``, ``p^T dO``, ``ds^T q`` and ``ds k`` once
    per bf16 term of their float32 ``p`` or ``ds`` (``nsplit`` terms in
    bf16, one in float32; ``flops_split``) -- and its bytes (q, k, v, o,
    and dO, dq, dk, dv, once each, with the float32 lse)."""
    from repro_torch.kernels.flash_attention.kernel import NSPLIT

    T = S if T is None else T
    nsplit = NSPLIT if bf16 else 1
    elt = 2 if bf16 else 4
    pairs = B * H * visible_pairs(S, T, causal, window)
    q_elts, kv_elts, lse_bytes = B * S * H * D, B * T * Hkv * D, B * H * S * 4
    out = {"pairs": pairs}
    for name, f_bf16, f_split, nbytes in (
            ("fwd", 2 * D * pairs, nsplit * 2 * D * pairs,
             (2 * q_elts + 2 * kv_elts) * elt + lse_bytes),
            ("bwd", 4 * D * pairs, nsplit * 6 * D * pairs,
             (4 * q_elts + 4 * kv_elts) * elt + lse_bytes)):
        out[name] = dict(flops=f_bf16 + f_split, flops_bf16=f_bf16,
                         flops_split=f_split, nsplit=nsplit, bytes=nbytes)
    return out


# ---------------------------------------------------------------------------
# The scans
# ---------------------------------------------------------------------------

def lru(B: int, S: int, W: int, elt: int) -> dict:
    """Forward reads a, b and writes h (2 operations a step); backward
    reads g, a, h and writes da, db (3 a step)."""
    n = B * S * W
    return {name: dict(flops=flops, bytes=n_io * n * elt)
            for name, n_io, flops in (("fwd", 3, 2 * n), ("bwd", 5, 3 * n))}


def ssm(B: int, S: int, d_in: int, n: int, u_elt: int) -> dict:
    """The selective scan: forward reads dt, u, B, C, A, D and writes y;
    backward reads those and gy and writes the six gradients (each once);
    6 float operations a state entry and 3 a row forward, 18 and 6
    backward; one exponential a (b, t, d, i) both ways."""
    rows, elems = B * S * d_in, B * S * d_in * n
    small = 2 * B * S * n * 4 + d_in * n * 4 + d_in * 4
    return {"fwd": dict(bytes=rows * (4 + u_elt + 4) + small,
                        flops=6 * elems + 3 * rows, exps=elems),
            "bwd": dict(bytes=rows * (4 + u_elt + 4 + 4 + 4) + 2 * small,
                        flops=18 * elems + 6 * rows, exps=elems)}
