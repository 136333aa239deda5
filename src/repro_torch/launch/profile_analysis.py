"""What one real round costs, counted launch by launch (the port's
counterpart of ``repro/launch/hlo_analysis.py``).

The reference re-derives the roofline's three inputs from the compiled
HLO text, multiplying each computation by its loops' trip counts.  The
port has no HLO: it runs the round eagerly, so this module counts the
round itself while it runs, and a loop is counted in full because every
launch is:

  * flops            -- ``torch.utils.flop_counter.FlopCounterMode`` over
                        the round's aten ops (matmuls, and the plain
                        attention on the CPU), plus each hand-written
                        kernel's own count: the kernels are bound through
                        ctypes, so no aten op sees them, and each ops
                        wrapper records its launch's operations and bytes
                        (:mod:`repro_torch.kernels.costs`, the same
                        formulas as the kernels' bounds);
  * hbm bytes        -- a kernel's from its formula; an aten op's are its
                        operand and result bytes (the ``HloCostAnalysis``
                        convention the reference's analyzer states; view
                        and allocation ops move nothing);
  * collective bytes -- per kind and site, every collective of the round
                        (:mod:`repro_torch.collectives` tallies them all),
                        priced in :mod:`repro_torch.launch.roofline`
                        (all-reduce 2x).

All numbers are this process's, i.e. per device.  :func:`count` runs a
function under the counters; :func:`top_collectives` and
:func:`top_kernels` rank what it saw.  :func:`profile` times a function's
device work by kernel group (:func:`kernel_group`) under
``torch.profiler``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# kernel-name substrings of each stage of the two ops that rank magnitude
# keys (bf16 and float32 kernels alike), and of int8's two stages
RANK_SELECT_STAGES = {
    "hist": ("hist_high_kernel", "hist_low_kernel", "select_hist_kernel"),
    "bin_sums": ("select_sum_kernel",),
    "select": ("select_exact_kernel", "select_stage"),
    "ties": ("count_ties_kernel", "tie_prefix_kernel"),
    "write": ("write_select_kernel", "select_write_kernel")}
INT8_STAGES = {"absmax": ("absmax_kernel",),
               "quantize": ("quantize_kernel",)}
SEGMENT_RANKS_STAGES = {
    "hist": ("rank_hist_kernel", "radix_hist_kernel"),
    "bases": ("rank_sum_kernel", "rank_above_kernel", "scan_reduce_kernel",
              "scan_partials_kernel", "scan_apply_kernel"),
    "rank": ("rank_write_kernel", "scatter_kernel")}


def kernel_group(name: str) -> str:
    """The group of a device kernel, by its (possibly mangled) name: each
    hand-written kernel of the port, the library's matmuls, copies and
    fills, and everything else."""
    low = name.lower()
    if "flash_fwd_kernel" in name or "flash_bwd_" in name:
        return "flash_attention"
    if "lru_fwd_kernel" in name or "lru_bwd_kernel" in name:
        return "lru_scan"
    if any(k in name for k in ("ssm_fwd_kernel", "ssm_bwd_kernel",
                               "ssm_reduce_kernel")):
        return "ssm_scan"
    if "partial_sum_kernel" in name:
        return "round_uplink_partial"
    if "downlink_presummed_kernel" in name:
        return "round_downlink_presummed"
    if "uplink_kernel" in name:
        return "round_uplink"
    if "downlink_kernel" in name:
        return "round_downlink"
    if "update_kernel" in name:
        return "fedplt_update"
    if any(k in name for names in RANK_SELECT_STAGES.values()
           for k in names):
        return "rank_select"
    if "absmax_kernel" in name or "quantize_kernel" in name:
        return "int8_quantize"
    if "sort_aggregate_" in name:     # every route's kernel
        return "sort_aggregate"
    if any(k in name for names in SEGMENT_RANKS_STAGES.values()
           for k in names):
        return "segment_ranks"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    if any(k in low for k in ("copy", "memcpy", "fill", "memset")):
        return "copy/fill"
    return "other elementwise/reduction"


def profile(fn, width=60, events=None):
    """``fn()`` under torch.profiler (it must end in a synchronize):
    ``(wall ms, {kernel group: device ms}, {kernel: device ms})``, the
    kernel names cut to ``width`` characters (None: whole; the profiler
    may report a name mangled, where the cut can drop the kernel's own
    name).  ``fn`` runs twice: the profiler traces the first call as its
    warm-up and drops it, and reports the second (a process that had
    profiled before could lose the first kernels of a traced call).
    ``events``, a dict, receives ``{kernel group: kernel executions}``
    of the reported call."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import schedule

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        prof.step()
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels_ms = {}, {}
    for e in prof.key_averages():
        # the step's own annotation spans the step on the device
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.key.startswith("ProfilerStep"):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
        name = e.key[:width]
        kernels_ms[name] = kernels_ms.get(name, 0.0) + ms
        if events is not None:
            events[g] = events.get(g, 0) + e.count
    return wall_ms, groups, kernels_ms


# ---------------------------------------------------------------------------
# Counting a round
# ---------------------------------------------------------------------------

def _tensor_bytes(tree) -> int:
    total = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            total += t.numel() * t.element_size()
    return total


class _ByteCounter(TorchDispatchMode):
    """Each aten op's calls and operand + result bytes (views and fresh
    allocations move nothing)."""

    def __init__(self):
        super().__init__()
        self.ops = defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        rec = self.ops[name]
        rec[0] += 1
        if not (func.is_view or name.startswith("aten.empty")
                or name in ("aten.detach", "aten.lift_fresh", "aten.alias")):
            rec[1] += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


@dataclasses.dataclass
class Costs:
    """One counted run, per device: ``flops`` and ``bytes`` of the aten
    ops and the kernels together; ``coll_bytes`` the collectives' bytes
    as priced (all-reduce 2x), ``coll_by_kind`` / ``coll_counts`` their
    buffers' bytes and calls by kind; the tables behind them: ``ops``
    (aten op -> calls, flops, bytes), ``kernels`` (kernel -> launches,
    flops, bytes) and ``collectives`` ((kind, site) -> calls, bytes)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)

    def launches(self) -> dict:
        """``{kernel: launches}`` of the hand-written kernels."""
        return {k: v["launches"] for k, v in self.kernels.items()}


def count(fn) -> tuple:
    """Run ``fn()`` under the counters; returns ``(fn's result, Costs)``.
    Clears the kernels' launch counts and tallies and the collective
    tally first, so :func:`repro_torch.kernels.launch_counts` reads this
    run's launches afterwards."""
    from repro_torch import collectives, kernels
    from repro_torch.launch import roofline

    kernels.reset_launch_counts()
    collectives.reset()
    flop_mode = FlopCounterMode(display=False)
    byte_mode = _ByteCounter()
    with flop_mode, byte_mode:
        result = fn()
    op_flops = {str(k): float(v) for k, v in
                flop_mode.get_flop_counts().get("Global", {}).items()}
    ops = {name: {"calls": c, "flops": op_flops.get(name, 0.0), "bytes": b}
           for name, (c, b) in byte_mode.ops.items()}
    kern = kernels.launch_costs()
    colls = collectives.tally()
    by_kind, counts = defaultdict(float), defaultdict(float)
    for (kind, _), v in colls.items():
        by_kind[kind] += v["bytes"]
        counts[kind] += v["calls"]
    costs = Costs(
        flops=float(flop_mode.get_total_flops())
        + sum(v["flops"] for v in kern.values()),
        bytes=sum(v["bytes"] for v in ops.values())
        + sum(v["bytes"] for v in kern.values()),
        coll_by_kind=dict(by_kind), coll_counts=dict(counts), ops=ops,
        kernels=kern, collectives=colls)
    costs.coll_bytes = roofline.collective_bytes(costs.coll_by_kind)["total"]
    return result, costs


def top_collectives(costs: Costs, k: int = 10) -> list:
    """The largest collectives of a counted run, by priced bytes (calls x
    buffer, all-reduce 2x): ``(bytes, kind, site, "xcalls")`` rows, the
    largest first -- what to attack first."""
    from repro_torch.launch.roofline import collective_bytes

    rows = []
    for (kind, site), v in costs.collectives.items():
        priced = collective_bytes({kind: v["bytes"]})["total"]
        rows.append((priced, kind, site, f"x{v['calls']}"))
    rows.sort(reverse=True)
    return rows[:k]


def top_kernels(costs: Costs, k: int = 10, bw: float = None) -> list:
    """The hand-written kernels and aten ops of a counted run by their
    least time on the card (:func:`repro_torch.launch.roofline.bound` of
    their bytes and operations, every operation at the bf16 tensor-core
    peak): ``(bound ms, name, calls, flops, bytes)`` rows, the largest
    first."""
    from repro_torch.launch import roofline

    bw = roofline.card_bandwidth(roofline.H100_SXM) if bw is None else bw
    rows = []
    for name, v in costs.kernels.items():
        rows.append((v["launches"], name, v["flops"], v["bytes"]))
    for name, v in costs.ops.items():
        rows.append((v["calls"], name, v["flops"], v["bytes"]))
    out = [(roofline.bound(bw, b, f, roofline.BF16_PEAK)["bound_ms"], name,
            calls, f, b) for calls, name, f, b in rows]
    out.sort(key=lambda r: -r[0])
    return out[:k]
