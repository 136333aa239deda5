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

:func:`ssm_scan_ref` and :func:`ssm_scan_bwd_ref` (below) are the plain
versions of the selective-scan kernels (``csrc/ssm_scan.cu``), used only
by the tests and ``chip_smoke.py``.
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


# ---------------------------------------------------------------------------
# The selective scan with its output contraction (csrc/ssm_scan.cu)
# ---------------------------------------------------------------------------
#
# Over (B, S, d_in) with state n, per channel (b, d, i)::
#
#     a_t = exp(dt_t A_i),  bx_t = (dt_t u_t) B_t,i
#     h_t = a_t h_{t-1} + bx_t,   y_t = sum_i h_t,i C_t,i + D u_t
#
# (a and bx rounded to bf16 under a bf16 scan dtype), walked in time order
# with the kernel's rounded operations: the sum over i in the kernel's
# lane tree (:func:`lane_tree_sum`), the sums over d_in in its blocks and
# groups of channels (:func:`_over_channel_blocks`), over b in batch order.  On the card
# the kernels equal these bit for bit.  The reference's ``ssm_mix_seq``
# takes the same recurrence in the same order and its own contraction
# order; its ``ssm_mix_fused`` an associative scan within a chunk.

SSM_BLOCK_CHANNELS = 64     # csrc/ssm_scan.cu kD: the channels of a block
SSM_CHANNEL_GROUPS = 4      # kGroups: a block's groups of channels in dB, dC
SSM_DTYPES = (torch.float32, torch.bfloat16)


def state_lanes(n: int) -> int:
    """The lanes of a channel's group: n rounded up to a power of two."""
    return 1 << (n - 1).bit_length()


def block_channels(n: int) -> int:
    """The channels d of one kernel block at state n (the backward sums
    dB and dC over d in blocks of this many, then across blocks): 64 at
    every n, whatever the lanes of a channel (``kernel.ssm_plan``)."""
    return SSM_BLOCK_CHANNELS


def lane_tree_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the kernel's tree order: padded with zeros
    to :func:`state_lanes`, then ``s[..., :P/2] + s[..., P/2:]``, halving
    until one entry is left (the kernel's first levels in a lane's
    registers, its last ones xor shuffles across the lanes of a channel)."""
    pad = state_lanes(s.shape[-1]) - s.shape[-1]
    if pad:
        s = torch.cat([s, s.new_zeros(s.shape[:-1] + (pad,))], dim=-1)
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return s[..., 0]


def _to_scan(x: torch.Tensor, scan_dtype) -> torch.Tensor:
    return x if scan_dtype == torch.float32 else x.to(scan_dtype).float()


def _coeffs(dt_t, u_t, B_t, A, scan_dtype):
    """One step's float32 ``exp(dt A)``, the ``a`` and ``bx`` the scan
    takes, and ``q = dt u``: (b, d, n), (b, d, n), (b, d), (b, d, n)."""
    a32 = torch.exp(dt_t[..., None] * A)
    q = dt_t * u_t
    bx = q[..., None] * B_t[:, None, :]
    return a32, _to_scan(a32, scan_dtype), q, _to_scan(bx, scan_dtype)


def _states(dt, uf, B, A, scan_dtype):
    h = dt.new_zeros(dt.shape[:1] + A.shape)
    out = []
    for t in range(dt.shape[1]):
        _, a, _, bx = _coeffs(dt[:, t], uf[:, t], B[:, t], A, scan_dtype)
        h = a * h + bx
        out.append(h)
    return out


def ssm_scan_ref(dt, u, B, C, A, D, scan_dtype=torch.float32):
    """y (B, S, d_in) float32 from dt (B, S, d_in) float32, u (B, S, d_in),
    B and C (B, S, n) float32, A (d_in, n) and D (d_in,) float32."""
    uf = u.float()
    hs = _states(dt, uf, B, A, scan_dtype)
    return torch.stack([lane_tree_sum(h * C[:, t, None, :]) + D * uf[:, t]
                        for t, h in enumerate(hs)], dim=1)


def _in_order(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` along dim 0, in that order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _over_channel_blocks(terms: torch.Tensor) -> torch.Tensor:
    """(B, S, d_in, n) -> (B, S, n): the sum over d in the kernel's order:
    zero-padded to whole blocks of :func:`block_channels`; within a block,
    each of its :data:`SSM_CHANNEL_GROUPS` groups of consecutive channels
    channel by channel, then the halving tree over the groups (as
    :func:`lane_tree_sum`); then block by block."""
    Bn, S, d_in, n = terms.shape
    kd = block_channels(n)
    n_blk = -(-d_in // kd)
    pad = n_blk * kd - d_in
    if pad:
        terms = torch.cat([terms, terms.new_zeros((Bn, S, pad, n))], dim=2)
    groups = terms.reshape(Bn, S, n_blk, SSM_CHANNEL_GROUPS,
                           kd // SSM_CHANNEL_GROUPS, n)
    blocks = lane_tree_sum(_in_order(groups.movedim(4, 0)).movedim(3, -1))
    return _in_order(blocks.movedim(2, 0))


def ssm_scan_bwd_ref(dt, u, B, C, A, D, gy, scan_dtype=torch.float32):
    """``(ddt, du, dB, dC, dA, dD)``, float32, given the upstream gradient
    gy (B, S, d_in) of y (see the module note for the recurrence)."""
    uf = u.float()
    S = dt.shape[1]
    hs = _states(dt, uf, B, A, scan_dtype)
    ddt, du = torch.empty_like(dt), torch.empty_like(dt)
    term_b = dt.new_empty(dt.shape + A.shape[1:])
    term_c = torch.empty_like(term_b)
    acc_a = dt.new_zeros(dt.shape[:1] + A.shape)
    acc_d = dt.new_zeros(dt.shape[:1] + A.shape[:1])
    lam = a_next = None
    for t in range(S - 1, -1, -1):
        a32, a, q, _ = _coeffs(dt[:, t], uf[:, t], B[:, t], A, scan_dtype)
        g = gy[:, t]
        dh = g[..., None] * C[:, t, None, :]
        lam = dh if lam is None else dh + a_next * lam
        h_prev = hs[t - 1] if t else torch.zeros_like(lam)
        da = _to_scan(lam * h_prev, scan_dtype)
        dbx = _to_scan(lam, scan_dtype)
        dp = da * a32
        acc_a = acc_a + dp * dt[:, t, :, None]
        s_a = lane_tree_sum(dp * A)
        s_b = lane_tree_sum(dbx * B[:, t, None, :])
        ddt[:, t] = s_a + s_b * uf[:, t]
        du[:, t] = s_b * dt[:, t] + g * D
        acc_d = acc_d + g * uf[:, t]
        term_b[:, t] = dbx * q[..., None]
        term_c[:, t] = g[..., None] * hs[t]
        a_next = a
    return (ddt, du, _over_channel_blocks(term_b),
            _over_channel_blocks(term_c), _in_order(acc_a), _in_order(acc_d))
