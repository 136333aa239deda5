"""Uplink compressor registry and leaf packing (counterpart of
``repro/fed/compress.py``, packing half).

The registry holds ``none`` only: the compressed z-exchange (topk, int8,
adaptive_topk and their kernels) is a later slice of the port.

Packing lays an agent-stacked tree (every leaf ``(N, ...)``) out as ONE
``(N, width)`` buffer: leaf ``j`` occupies columns ``segments[j]``.  The
port starts every segment at a multiple of :data:`_ALIGN` elements (so a
leaf's view is aligned for the matrix kernels that read it) and pads the
width to the same multiple; a single leaf is its own buffer, unpadded.
The JAX package pads only the total width to 128 lanes -- the two
layouts may differ, which is why the tests compare trees, not buffers.

:func:`unpack_leaves` and :func:`unpack_row` return VIEWS into the
buffer, so the trainer runs the model on its packed state without a copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

# (dz_rows (N, m), round_cfg) -> transmitted rows (N, m)
CompressFn = Callable[[torch.Tensor, Any], torch.Tensor]

_REGISTRY: Dict[str, CompressFn] = {}

# segment alignment of the packed buffer, in elements
_ALIGN = 64


def register_compressor(name: str) -> Callable[[CompressFn], CompressFn]:
    """Decorator registering a per-agent row compressor under ``name``."""

    def deco(fn: CompressFn) -> CompressFn:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_compressor(name: str) -> CompressFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; registered: "
            f"{', '.join(available_compressors())}") from None


def available_compressors() -> list[str]:
    return sorted(_REGISTRY)


@register_compressor("none")
def compress_none(dz: torch.Tensor, cfg) -> torch.Tensor:
    """Exact exchange: transmit the full-precision increment."""
    del cfg
    return dz


# ---------------------------------------------------------------------------
# Leaf packing: the whole agent-stacked tree as one (N, width) buffer
# ---------------------------------------------------------------------------

class PackedMeta(NamedTuple):
    """Static layout of a packed agent-stacked tree."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]      # per-leaf (N, ...) shapes
    segments: Tuple[Tuple[int, int], ...]    # per-leaf (start, stop) cols
    width: int                               # padded column count
    dtype: torch.dtype

    @property
    def m_total(self) -> int:
        """Data columns (without padding)."""
        return sum(s1 - s0 for s0, s1 in self.segments)


def _numel(shape) -> int:
    m = 1
    for d in shape:
        m *= d
    return m


def packed_meta(tree: Any) -> PackedMeta:
    """The layout :func:`pack_leaves` records for ``tree`` -- shape
    arithmetic only, so the leaves may be meta-device tensors and the
    trainer derives its layout without a tree-form state."""
    leaves, treedef = pytree.tree_flatten(tree)
    if not leaves:
        raise ValueError("packed_meta: empty tree")
    n, dtype = leaves[0].shape[0], leaves[0].dtype
    for l in leaves:
        if l.shape[0] != n or l.dtype != dtype:
            raise ValueError(
                "pack_leaves needs a uniform agent axis and dtype, got "
                f"{[(tuple(x.shape), x.dtype) for x in leaves]}")
    segments, start = [], 0
    for l in leaves:
        if len(leaves) > 1:
            start = -(-start // _ALIGN) * _ALIGN
        m = _numel(l.shape[1:])
        segments.append((start, start + m))
        start += m
    width = start if len(leaves) == 1 else -(-start // _ALIGN) * _ALIGN
    return PackedMeta(treedef=treedef,
                      shapes=tuple(tuple(l.shape) for l in leaves),
                      segments=tuple(segments), width=width, dtype=dtype)


def pack_leaves(tree: Any, meta: PackedMeta = None) -> Tuple[torch.Tensor,
                                                              PackedMeta]:
    """Copy every ``(N, ...)`` leaf into its column segment of a new
    ``(N, width)`` buffer (padding columns zero)."""
    meta = packed_meta(tree) if meta is None else meta
    leaves = pytree.tree_leaves(tree)
    n = leaves[0].shape[0]
    buf = torch.zeros((n, meta.width), dtype=meta.dtype,
                      device=leaves[0].device)
    for l, (s0, s1) in zip(leaves, meta.segments):
        buf[:, s0:s1] = l.reshape(n, s1 - s0)
    return buf, meta


def unpack_leaves(buf: torch.Tensor, meta: PackedMeta) -> Any:
    """The tree of ``(n, ...)`` views of ``buf`` (``n`` from the buffer,
    so a row slice unpacks with the same meta)."""
    n = buf.shape[0]
    leaves = [buf[:, s0:s1].view((n,) + shape[1:])
              for (s0, s1), shape in zip(meta.segments, meta.shapes)]
    return pytree.tree_unflatten(leaves, meta.treedef)


def unpack_row(row: torch.Tensor, meta: PackedMeta) -> Any:
    """One agent's tree: views of a 1-D buffer row."""
    leaves = [row[s0:s1].view(shape[1:])
              for (s0, s1), shape in zip(meta.segments, meta.shapes)]
    return pytree.tree_unflatten(leaves, meta.treedef)


def pack_coord(tree: Any, meta: PackedMeta) -> torch.Tensor:
    """Pack a coordinator tree (leaves without the agent axis) into a
    ``(1, width)`` buffer aligned with ``meta``'s segments."""
    leaves = pytree.tree_leaves(tree)
    if len(leaves) != len(meta.shapes):
        raise ValueError(f"coordinator tree has {len(leaves)} leaves, "
                         f"meta has {len(meta.shapes)}")
    buf = torch.zeros((1, meta.width), dtype=meta.dtype,
                      device=leaves[0].device)
    for l, shape, (s0, s1) in zip(leaves, meta.shapes, meta.segments):
        if tuple(l.shape) != tuple(shape[1:]):
            raise ValueError(f"coordinator leaf {tuple(l.shape)} does not "
                             f"match agent leaf {tuple(shape)}")
        buf[0, s0:s1] = l.reshape(-1)
    return buf


def unpack_coord(buf: torch.Tensor, meta: PackedMeta) -> Any:
    """Invert :func:`pack_coord` (views of the ``(1, width)`` buffer)."""
    return unpack_row(buf[0], meta)
