"""Plain PyTorch version of the lru_scan kernels (counterpart of
``repro/kernels/lru_scan/ref.py``).

The diagonal linear recurrence over ``(B, S, W)``::

    h_t = a_t h_{t-1} + b_t,    h_{-1} = 0

in float32, the output in a's dtype.  Both functions walk time in order,
one product and one sum per step, each rounded on its own -- the order
the card's kernels take -- so on the card the kernels equal them bit for
bit.  The reference's oracle (an associative scan) rounds in an order
XLA picks; the CPU tests hold the two to a stated tolerance.

:func:`lru_scan_bwd_ref` is the gradient against an upstream ``g`` of
``h``, a reverse scan::

    lam_t = g_t + a_{t+1} lam_{t+1}     (lam_{S-1} = g_{S-1})
    db_t  = lam_t,    da_t = lam_t h_{t-1}     (h_{-1} = 0)

reading the forward's ``h`` as stored (in bfloat16 it carries h's
rounding, as the flash backward's ``delta`` carries O's).
"""

from __future__ import annotations

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) in a's dtype."""
    a32, b32 = a.float(), b.float()
    out = torch.empty_like(a32)
    h = torch.zeros_like(a32[:, 0])
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def lru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                     g: torch.Tensor):
    """``(da, db)`` in a's dtype, given a, the forward's output h and the
    upstream gradient g, all (B, S, W)."""
    S = a.shape[1]
    a32, h32, g32 = a.float(), h.float(), g.float()
    da = torch.empty_like(a32)
    db = torch.empty_like(a32)
    lam = None
    for t in range(S - 1, -1, -1):
        lam = g32[:, t] if lam is None else g32[:, t] + a32[:, t + 1] * lam
        db[:, t] = lam
        h_prev = h32[:, t - 1] if t else torch.zeros_like(lam)
        da[:, t] = lam * h_prev
    return da.to(a.dtype), db.to(a.dtype)
