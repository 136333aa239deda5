"""Hand-written Hopper kernels of the port (counterpart of
``repro/kernels``).

Each suite is ``<name>/{kernel.py, ops.py, ref.py}`` plus ``csrc/``:
``csrc/*.cu`` is the CUDA C++ source (sm_90a), ``kernel.py`` builds it
and launches it through ctypes, ``ref.py`` is the plain PyTorch version,
and ``ops.py`` sends CUDA tensors to the kernel and CPU tensors to the
plain version.

  round_edge     -- the round's coordinator edges on the packed
                    ``(N, M)`` agent buffer: mean + prox + reflection
                    (uplink), z-update + participation selects (downlink);
                    and their sharded halves on one rank's row block:
                    the partial column sum and the downlink given ``y``.
  fedplt_update  -- the fused local step ``w - gamma (g + (w - v)/rho)
                    [+ noise]``.
  compress       -- the compressed z-uplink on the packed buffer: exact-k
                    magnitude selection (topk, adaptive_topk) and int8
                    quantize-dequantize, per (agent, segment); and the
                    stable descending-|x| ranks within every column
                    interval (``segment_ranks``, a radix sort).
  robust_agg     -- the byzantine-robust coordinator aggregate: per column
                    of the ``(N, M)`` buffer, sort the live agents' values
                    and reduce to a trimmed mean or the median.
  flash_attention -- the model's attention: online-softmax forward (GQA,
                    causal mask, sliding window, logit softcap; o and the
                    float32 log-sum-exp) and its backward (delta, dK/dV,
                    dQ), behind a ``torch.autograd.Function``.
  lru_scan       -- the SSM / RG-LRU time mixing: the diagonal linear
                    recurrence ``h_t = a_t h_{t-1} + b_t`` (forward) and
                    its reverse scan (backward), behind a
                    ``torch.autograd.Function``; and the Mamba block's
                    fused output, the selective scan from ``(dt, u, B, C)``
                    to ``y = <h, C> + D u`` with its backward
                    (``ssm_scan``), behind another.

Every ops wrapper counts its kernel launches and records each launch's
operations and bytes (:mod:`.costs`); :func:`launch_counts` and
:func:`launch_costs` read them, :func:`reset_launch_counts` clears both.
"""


def _wrappers() -> dict:
    from repro_torch.kernels.compress import ops as compress_ops
    from repro_torch.kernels.fedplt_update import ops as update_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.robust_agg import ops as robust_ops
    from repro_torch.kernels.round_edge import ops as edge_ops

    return {"round_uplink": edge_ops.round_uplink,
            "round_downlink": edge_ops.round_downlink,
            "round_uplink_partial": edge_ops.round_uplink_partial,
            "round_downlink_presummed": edge_ops.round_downlink_presummed,
            "fedplt_update": update_ops.fedplt_update,
            "rank_select": compress_ops.rank_select,
            "segment_ranks": compress_ops.segment_ranks,
            "int8_quantize": compress_ops.int8_quantize,
            "sort_aggregate": robust_ops.robust_aggregate,
            "flash_attention_fwd": flash_ops.flash_attention_fwd,
            "flash_attention_bwd": flash_ops.flash_attention_bwd,
            "lru_scan_fwd": lru_ops.lru_scan_fwd,
            "lru_scan_bwd": lru_ops.lru_scan_bwd,
            "ssm_scan_fwd": lru_ops.ssm_scan_fwd,
            "ssm_scan_bwd": lru_ops.ssm_scan_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def launch_costs() -> dict:
    """``{kernel: {"launches", "flops", "bytes"}}`` of the launches since
    the last reset (:mod:`.costs`)."""
    from repro_torch.kernels import costs

    return costs.tally()


def reset_launch_counts() -> None:
    from repro_torch.kernels import costs

    for fn in _wrappers().values():
        fn.launches = 0
    costs.reset()


def kernel_sources() -> list:
    """The CUDA sources of every suite (for a parallel build)."""
    from repro_torch.kernels.compress import kernel as compress_kernel
    from repro_torch.kernels.fedplt_update import kernel as update_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.robust_agg import kernel as robust_kernel
    from repro_torch.kernels.round_edge import kernel as edge_kernel

    return [edge_kernel.SOURCE, update_kernel.SOURCE, compress_kernel.SOURCE,
            compress_kernel.RANKS_SOURCE, robust_kernel.SOURCE,
            flash_kernel.SOURCE, lru_kernel.SOURCE, lru_kernel.SSM_SOURCE]
