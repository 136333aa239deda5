"""The port's collectives, tallied.

Every collective of a round -- :mod:`repro_torch.fed.sharding`'s sums
and gathers, and the sharded uplink of
:mod:`repro_torch.kernels.round_edge.ops` -- goes through
:func:`all_reduce`, which tallies each call's kind (the operation issued),
site (the helper that issued it) and bytes: :func:`tally` reads the tally
and :func:`reset` clears it (:mod:`repro_torch.launch.profile_analysis`
reads it for a round's report).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# (kind, site) -> [calls, bytes] of the collectives since the last reset
_TALLY: dict = {}


def all_reduce(t: torch.Tensor, group, site: str) -> None:
    """``dist.all_reduce`` of ``t`` over ``group``, tallied at ``site``."""
    rec = _TALLY.setdefault(("all-reduce", site), [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)


def tally() -> dict:
    """``{(kind, site): {"calls", "bytes"}}`` of the collectives issued
    since the last reset: the kind is the operation (the port's gathers
    are all-reduces of a zero-filled buffer), the bytes the buffer's (one
    rank's view)."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in _TALLY.items()}


def reset() -> None:
    _TALLY.clear()
