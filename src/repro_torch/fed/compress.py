"""Uplink compressors and leaf packing (counterpart of
``repro/fed/compress.py``).

A compressor maps a flattened per-leaf increment ``dz`` of shape
``(N, m)`` (one row per agent) to the values actually transmitted; the
round engine advances the coordinator's lagged copy ``t`` by exactly
what was transmitted.  Registered: ``none``, ``topk``, ``int8`` and
``adaptive_topk`` (plain torch, with the tie and key rules of
:mod:`repro_torch.kernels.compress.ref`); :func:`register_compressor`
adds more, reachable by name from ``FedSpec`` and the CLI.

Backends (``cfg.compress_backend``, the port's names): ``"torch"`` runs
the registry function leaf by leaf (the reference's ``"xla"``);
``"fused"`` runs the compressors of :data:`FUSED_COMPRESSORS` as ONE
:mod:`repro_torch.kernels.compress` launch on the packed ``(N, width)``
buffer with per-leaf segments (the reference's ``"pallas"``); other
compressors take the registry path under either.  ``"auto"`` means the
kernel wherever one exists (:func:`resolve_backend`).  Both backends give
the same bits.

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

from repro_torch.fed import sharding
from repro_torch.kernels.compress import ops as compress_ops
from repro_torch.kernels.compress import ref as compress_ref

# (dz_rows (N, m), round_cfg) -> transmitted rows (N, m)
CompressFn = Callable[[torch.Tensor, Any], torch.Tensor]

_REGISTRY: Dict[str, CompressFn] = {}

COMPRESS_BACKENDS = ("auto", "torch", "fused")
# registry names with a kernel
FUSED_COMPRESSORS = frozenset({"topk", "adaptive_topk", "int8"})

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


@register_compressor("topk")
def compress_topk(dz: torch.Tensor, cfg) -> torch.Tensor:
    """Keep the ``compress_ratio`` fraction of largest-magnitude entries
    per agent, exactly ``max(1, int(ratio * m))`` of them (ties by
    position: a threshold would transmit every tied entry)."""
    return compress_ref.rank_select_ref(dz, None, "topk", cfg.compress_ratio)


@register_compressor("int8")
def compress_int8(dz: torch.Tensor, cfg) -> torch.Tensor:
    """Symmetric per-agent int8 quantization (scale = max|dz| / 127)."""
    del cfg
    return compress_ref.int8_ref(dz)


@register_compressor("adaptive_topk")
def compress_adaptive_topk(dz: torch.Tensor, cfg) -> torch.Tensor:
    """Per-agent adaptive top-k: each agent keeps the smallest k_i whose
    top entries capture a ``compress_energy`` fraction of its increment's
    l2 energy, floored at ``max(1, int(ratio * m))`` (the energy is
    summed in float64: :mod:`repro_torch.kernels.compress.ref`)."""
    return compress_ref.rank_select_ref(dz, None, "adaptive_topk",
                                        cfg.compress_ratio,
                                        cfg.compress_energy)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

def resolve_backend(cfg) -> str:
    """``cfg.compress_backend`` as ``"torch"`` or ``"fused"``.

    ``"auto"`` takes the kernel wherever one exists.  The reference's
    ``"auto"`` rule (``_AUTO_INT8_MIN_COLS``, and static topk always on
    XLA) rests on ``BENCH_compress.json``, timed on a CPU in interpret
    mode; it says nothing of the card, where the kernel replaces a sort
    of every segment (or, for int8, five unfused passes) with a few
    streaming passes.  The two backends give the same bits."""
    backend = getattr(cfg, "compress_backend", "torch")
    if backend not in COMPRESS_BACKENDS:
        raise ValueError(f"unknown compress backend {backend!r}; known: "
                         f"{', '.join(COMPRESS_BACKENDS)}")
    if backend == "auto":
        return "fused" if cfg.compression in FUSED_COMPRESSORS else "torch"
    return backend


def _use_fused(cfg) -> bool:
    return (cfg.compression in FUSED_COMPRESSORS
            and resolve_backend(cfg) == "fused")


def _fused_rows(dz: torch.Tensor, cfg, segments=None) -> torch.Tensor:
    """The kernel compressor on an ``(N, m)`` buffer with column
    segments (None: one segment)."""
    if cfg.compression == "int8":
        return compress_ops.int8_quantize(dz, segments=segments)
    return compress_ops.rank_select(dz, segments=segments,
                                    mode=cfg.compression,
                                    ratio=cfg.compress_ratio,
                                    energy=cfg.compress_energy)


def compress_rows(dz: torch.Tensor, cfg) -> torch.Tensor:
    """The configured compressor on a flattened ``(N, m)`` increment."""
    if _use_fused(cfg):
        return _fused_rows(dz, cfg)
    return get_compressor(cfg.compression)(dz, cfg)


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


# ---------------------------------------------------------------------------
# Compressing an increment
# ---------------------------------------------------------------------------

def compress_increment(dz: Any, cfg, blocks=None) -> Any:
    """The configured compressor on an agent-stacked increment tree
    (scales and keep-counts per agent per leaf).  Torch backend: leaf by
    leaf.  Fused backend: the leaves are packed into one buffer and the
    kernel runs once, with one segment per leaf.  A tree of leaf
    ``blocks`` (:class:`repro_torch.fed.sharding.TreeBlocks`) is gathered
    over the model group, compressed whole and cut back to the blocks --
    bit-equal to the unsplit run."""
    if blocks is not None:
        full = compress_increment(blocks.gather_tree(dz), cfg)
        return {n: l.contiguous()
                for n, l in blocks.block_tree(full).items()}
    leaves = pytree.tree_leaves(dz)
    if _use_fused(cfg):
        if len({(l.shape[0], l.dtype) for l in leaves}) == 1:
            buf, meta = pack_leaves(dz)
            return unpack_leaves(_fused_rows(buf, cfg, meta.segments), meta)
        # mixed dtypes have no single wire format: one launch per leaf
        return pytree.tree_map(
            lambda l: _fused_rows(l.reshape(l.shape[0], -1),
                                  cfg).reshape(l.shape), dz)
    fn = get_compressor(cfg.compression)
    return pytree.tree_map(
        lambda l: fn(l.reshape(l.shape[0], -1), cfg).reshape(l.shape), dz)


def compress_increment_packed(dz_buf: torch.Tensor, meta: PackedMeta,
                              cfg, mesh=None) -> torch.Tensor:
    """The configured compressor on a resident packed ``(N, width)``
    increment.  Fused: one kernel launch with ``meta.segments``.  Torch:
    the registry function per segment, written into a zero buffer.
    Columns outside every segment (the alignment gaps between leaves and
    the padded tail) come back zero under both, so ``t``'s padding stays
    zero across rounds.

    With a ``mesh`` whose model axis splits the columns, ``dz_buf`` is
    this rank's column block: the segments are leaves of the global
    layout (keep-counts and scales per (row, global segment)), so the
    block's rows are gathered over the model group, compressed whole and
    cut back to the block -- bit-equal to the unsplit run."""
    if mesh is not None and sharding.cols_split(mesh, meta.width):
        full = sharding.model_gather(dz_buf, mesh, meta.width)
        return sharding.col_block(
            compress_increment_packed(full, meta, cfg), mesh).contiguous()
    if _use_fused(cfg):
        return _fused_rows(dz_buf, cfg, meta.segments)
    fn = get_compressor(cfg.compression)
    out = torch.zeros_like(dz_buf)
    for s0, s1 in meta.segments:
        out[:, s0:s1] = fn(dz_buf[:, s0:s1], cfg)
    return out
