"""The H100 roofline (counterpart of ``repro/launch/roofline.py``).

Three terms per round or step, in seconds, on a per-device basis:

    compute    = FLOPs_per_device / BF16_PEAK
    memory     = HBM_bytes_per_device / the card's memory rate
    collective = collective_bytes_per_device / NVLINK_BW

The counts come from :mod:`repro_torch.launch.profile_analysis` (a real
round: aten ops through ``torch.utils.flop_counter``, the hand-written
kernels' own counts, the collectives that :mod:`repro_torch.fed.sharding`
tallies) or, in the dry run, analytically.  Every FLOP is priced at the
bf16 tensor-core peak, so the compute term is a lower bound.

The hardware is one H100 SXM (the data sheet's numbers; a card set below
its 700 W limit runs slower under load).  The least-time formulas of the
kernels (:func:`flash_bounds`, :func:`lru_bounds`, :func:`ssm_bounds`,
:func:`bound`) price :mod:`repro_torch.kernels.costs`' counts on these
rates, so a kernel's bound and a round's report read one count.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import costs

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core FLOP/s
BF16_PEAK = 989e12
# NVIDIA H100 SXM5 data sheet: float32 on the CUDA cores (no tensor
# cores), an FMA counted as two FLOPs
FP32_PEAK = 67e12
# NVIDIA H100 SXM5 data sheet: NVLink 4, 900 GB/s bidirectional, so 450
# GB/s each direction
NVLINK_BW = 450e9
# the exponential's rate: 16 MUFU results a clock an SM on compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instructions), 132
# SMs at the H100 SXM's 1.98 GHz boost clock
EXP_RATE = 16 * 132 * 1.98e9
# the float32 rate of kernels built with --fmad=false: every multiply and
# add issues on its own, 128 a clock an SM (FP32_PEAK counts an FMA as two)
FP32_OPS_NO_FMA = 128 * 132 * 1.98e9
# the card the dry run prices by default
H100_SXM = "NVIDIA H100 80GB HBM3"


def card_bandwidth(name: str) -> float:
    """Data-sheet memory rate (bytes/s) of the named card; raises a
    ValueError for a card it does not know."""
    if "H100" not in name and "H200" not in name:
        raise ValueError(f"no data-sheet bandwidth known for {name!r}")
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


# ---------------------------------------------------------------------------
# Kernel bounds: a count priced on the card's rates
# ---------------------------------------------------------------------------

def bound(bw: float, nbytes: float, flops: float,
          peak: float = FP32_PEAK) -> dict:
    """The least time of moving ``nbytes`` at ``bw`` and doing ``flops``
    at ``peak``: ``{"bytes", "flops", "bound_ms", "bound_by"}``."""
    by_bytes = nbytes / bw >= flops / peak
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(nbytes / bw, flops / peak) * 1e3,
                bound_by="bytes" if by_bytes else "operations")


def flash_bounds(bw, B, S, H, Hkv, D, causal, window, T=None):
    """The least time of the bf16 flash forward and backward at a shape
    (``T`` keys, ``S`` by default): the larger of the bytes over the
    memory rate and the operations as the tensor-core kernels run them,
    all at the bf16 tensor-core peak (:func:`repro_torch.kernels.costs.flash`)."""
    c = costs.flash(B, S, H, Hkv, D, causal, window, T=T)
    out = {"pairs": c["pairs"]}
    for name in ("fwd", "bwd"):
        k = c[name]
        ops_s = k["flops"] / BF16_PEAK
        out[name] = dict(
            bound_ms=max(k["bytes"] / bw, ops_s) * 1e3,
            bound_by="bytes" if k["bytes"] / bw >= ops_s else "operations",
            flops_bf16=k["flops_bf16"], flops_split=k["flops_split"],
            nsplit=k["nsplit"], bytes=k["bytes"])
    return out


def plain_flash_bound(bw, B, S, T, H, Hkv, D, causal):
    """The bound at a flash shape as 4 D operations a visible (query,
    key) pair forward and 10 D backward at the bf16 tensor-core peak,
    against the bytes (q, k, v, o and the lse forward; with dO, dq, dk,
    dv backward) over the memory rate."""
    pairs = B * H * costs.visible_pairs(S, T, causal, None)
    q, kv, lse = B * S * H * D, B * T * Hkv * D, B * H * S * 4
    out = {}
    for name, ops, nbytes in (("fwd", 4 * D * pairs, (2 * q + 2 * kv) * 2
                               + lse),
                              ("bwd", 10 * D * pairs, (4 * q + 4 * kv) * 2
                               + lse)):
        ops_ms, bytes_ms = ops / BF16_PEAK * 1e3, nbytes / bw * 1e3
        out[name] = dict(bound_ms=max(ops_ms, bytes_ms),
                         bound_by="operations" if ops_ms >= bytes_ms
                         else "bytes", flops=ops, bytes=nbytes)
    return out


def lru_bounds(bw, B, S, W, elt):
    """The least time of the scans at a shape: the bytes over the memory
    rate, or the float operations over the float32 peak, whichever is
    larger (:func:`repro_torch.kernels.costs.lru`)."""
    return {name: bound(bw, c["bytes"], c["flops"])
            for name, c in costs.lru(B, S, W, elt).items()}


def ssm_bounds(bw, B, S, d_in, n, u_elt):
    """The least time of the selective scan at a shape: the bytes over
    the memory rate; the float operations over :data:`FP32_OPS_NO_FMA`;
    and one exponential a (b, t, d, i) over :data:`EXP_RATE`; whichever
    is largest (:func:`repro_torch.kernels.costs.ssm`)."""
    out = {}
    for name, c in costs.ssm(B, S, d_in, n, u_elt).items():
        times = {"bytes": c["bytes"] / bw, "flops": c["flops"] / FP32_OPS_NO_FMA,
                 "exp": c["exps"] / EXP_RATE}
        worst = max(times, key=times.get)
        out[name] = dict(bytes=c["bytes"], flops=c["flops"], exps=c["exps"],
                         bound_ms=times[worst] * 1e3,
                         bound_by="bytes" if worst == "bytes"
                         else "operations")
    return out


# ---------------------------------------------------------------------------
# The roofline of a round
# ---------------------------------------------------------------------------

# all-reduce is priced 2x its buffer (a ring's reduce and broadcast); the
# port's gathers are all-reduces of a zero-filled buffer (sharding.py)
_PRICE = {"all-reduce": 2.0}


def collective_bytes(coll_by_kind: dict) -> dict:
    """The collectives' bytes a device moves, by kind: ``coll_by_kind``
    maps a kind to its buffers' bytes (``Costs.coll_by_kind``); all-reduce
    is priced 2x.  Returns ``{"per_kind", "total"}``."""
    per = {k: _PRICE.get(k, 1.0) * v for k, v in coll_by_kind.items()}
    return {"per_kind": per, "total": sum(per.values())}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device, every launch counted
    hbm_bytes: float             # per device
    coll_bytes: float            # per device, priced (all-reduce 2x)
    coll_detail: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6 N D analytic (global)
    useful_ratio: float          # model_flops_per_device / flops
    # the reference's raw XLA cost-analysis cross-check; the port has no
    # XLA, so these stay 0.0 (kept so a record reads as the reference's)
    xla_flops: float = 0.0
    xla_bytes: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(costs_, model_flops: float, n_devices: int,
            bw: float = None) -> Roofline:
    """The three terms of counted costs: ``costs_`` has ``flops``,
    ``bytes``, ``coll_by_kind`` and ``coll_counts`` per device (a
    :class:`repro_torch.launch.profile_analysis.Costs`); ``bw`` is the
    card's memory rate (the H100 SXM's by default)."""
    bw = card_bandwidth(H100_SXM) if bw is None else bw
    coll = collective_bytes(dict(costs_.coll_by_kind))
    compute_s = costs_.flops / BF16_PEAK
    memory_s = costs_.bytes / bw
    collective_s = coll["total"] / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mf_dev = model_flops / max(n_devices, 1)
    return Roofline(
        flops=costs_.flops, hbm_bytes=costs_.bytes,
        coll_bytes=coll["total"],
        coll_detail={"per_kind": coll["per_kind"],
                     "counts": dict(costs_.coll_counts)},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=(mf_dev / costs_.flops) if costs_.flops else 0.0)


def mfu(model_flops: float, seconds: float, n_devices: int = 1) -> float:
    """Model FLOPs utilisation: ``model_flops`` over ``seconds`` of
    ``n_devices`` cards at the bf16 tensor-core peak."""
    return model_flops / (seconds * n_devices * BF16_PEAK)


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (6 N D for dense; 6 N_active D for MoE)
# ---------------------------------------------------------------------------

def active_param_count(cfg) -> int:
    """Parameters touched per token (routed experts counted top_k/E)."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.resolved_head_dim
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    gated = cfg.activation in ("swiglu", "geglu")
    per_ff = d * ff * (3 if gated else 2)
    total = 0
    kinds = cfg.layer_kinds()
    for kind in kinds:
        if kind == "ssm":
            d_in, n, r = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
            total += d * 2 * d_in + d_in * (r + 2 * n) + r * d_in \
                + d_in * n + d_in * d
        elif kind == "rec":
            w = cfg.resolved_lru_width
            total += 2 * d * w + 2 * w * w + w * d + per_ff
        else:
            total += attn
            if cfg.n_experts:
                e_ff = cfg.moe_d_ff * (3 if gated else 2) * d
                total += cfg.top_k * e_ff \
                    + cfg.n_shared_experts * e_ff + d * cfg.n_experts
            else:
                total += per_ff
    if cfg.n_enc_layers:
        total += cfg.n_enc_layers * (attn + per_ff) \
            + cfg.n_layers * attn          # cross attention
    total += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return total


def model_flops(cfg, shape, mode: str) -> float:
    """6 N D (train), 2 N D (prefill/forward), 2 N per token (decode)."""
    n_active = active_param_count(cfg)
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
