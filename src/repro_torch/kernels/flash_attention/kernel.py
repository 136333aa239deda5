"""Launchers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py``'s
``flash_attention_bhsd`` (``_flash_kernel``), and adds the backward that
the reference leaves to autodiff.  Bound by operations: per (query, key)
pair a row sees, ``4 D`` floating-point operations forward (``q k`` and
``p v``) and ``10 D`` backward (the products ``s``, ``dp``, ``dV``,
``dK``, ``dQ``).

bfloat16 runs on the tensor cores: every product is a ``wgmma`` with
float32 accumulation; the float32 ``p`` (and ``ds``) is split into
``NSPLIT = 2`` bf16 terms, one product per term, so ``p v``, ``p^T dO``,
``ds^T q`` and ``ds k`` keep the reference's float32 ``p``; K/V (forward,
dQ) or Q/dO (dK/dV) tiles stream through a 2-stage ring of TMA copies
that one producer thread keeps ahead of two consumer warpgroups (64
rows of one head each; 64-key steps, 32 in dQ; D padded to 64, 128 or
256).  On the card the float32 elementwise work between the products
(masks, the precise ``tanh`` softcap, ``exp``, the splits) takes about
as long as the products, and at the trainer's 512 tokens the grid is
short of the 132 SMs.  float32 keeps the CUDA-core kernels (tensor
cores have no float32 product at float32 precision).  The source
file's header gives the design in full.

* forward: one launch reads q ``(B, S, H, D)`` and k, v ``(B, T, Hkv,
  D)`` once per q block and writes o ``(B, S, H, D)`` in their dtype and
  the float32 log-sum-exp ``(B, H, S)``.
* backward: one call launches ``delta = rowsum(dO * O)`` into a float32
  ``(B, H, S)`` scratch, dK/dV and dQ; it reads q, k, v, o, dO, lse and
  writes dq, dk, dv in the inputs' dtype.  In bfloat16 the dK/dV kernel
  takes one query head a CTA: with ``H > Hkv`` it writes float32
  partials into a ``(2, G, B, T, Hkv, D)`` scratch, summed in head order
  by a fourth kernel (no atomics: two runs give the same bits).

GQA is index mapping inside the kernels (query head ``h`` reads kv head
``h // G``); nothing is repeated.  q and k/v differ in their head count,
so the operands are checked here rather than by
:func:`repro_torch.kernels._cuda.check_operands`.

The library is compiled on the first launch (:mod:`repro_torch.kernels.build`).
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (F32, I64, INT, PTR, check_launch, ptr,
                                       stream_of)

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"

MAX_HEAD_DIM = 256        # the largest DP the kernels are built for
NSPLIT = 2                # bf16 terms of p and ds (the source's NSPLIT)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_flash_fwd.argtypes = [PTR] * 5 + [I64, I64, I64] + [INT] * 6 \
        + [F32, F32, PTR]
    lib.repro_flash_fwd.restype = INT
    lib.repro_flash_bwd.argtypes = [PTR] * 11 + [I64, I64, I64] + [INT] * 6 \
        + [F32, F32, PTR]
    lib.repro_flash_bwd.restype = INT
    return lib


def check_attention(name: str, q, k, v, *, window, cap, **others) -> None:
    """Raise unless q ``(B, S, H, D)`` and k, v ``(B, T, Hkv, D)`` are
    contiguous CUDA tensors of one float32 or bfloat16 dtype with ``H``
    a multiple of ``Hkv``, ``T >= 1`` and ``D`` up to 256, a multiple of
    4 in float32 (four columns a load) and of 8 in bfloat16 (TMA rows
    are 16-byte multiples), each operand 16-byte aligned; ``others`` are
    checked against q's shape (``(B, S, H, D)``), or ``(B, H, S)``
    float32 for ``lse``."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"{name}: q must be (B, S, H, D) and k, v "
                         f"(B, T, Hkv, D)")
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, Hkv, D) or Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: k has shape {tuple(k.shape)} for q "
                         f"{tuple(q.shape)} (want (B, T, Hkv, D), H % Hkv "
                         f"== 0)")
    if T < 1:
        raise ValueError(f"{name}: no keys (T = 0)")
    if D > MAX_HEAD_DIM or D % 4:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 4 "
                         f"and at most {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} < 1")
    if cap is not None and not cap > 0:
        raise ValueError(f"{name}: softcap {cap} must be positive")
    want = {"k": (k.dtype, tuple(k.shape)), "v": (k.dtype, tuple(k.shape)),
            "lse": (torch.float32, (B, H, S))}
    for key, t in {"q": q, "k": k, "v": v, **others}.items():
        dtype, shape = want.get(key, (q.dtype, tuple(q.shape)))
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"want {dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if q.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8 "
                         f"in bfloat16")
    for key, t in {"q": q, "k": k, "v": v, **others}.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not aligned to 16 bytes")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: kernel operands must be CUDA tensors")


def _args(q, k, causal, window, cap):
    """The launchers' shape and option arguments."""
    B, S, H, D = q.shape
    return (B, S, k.shape[1], H, k.shape[2], D, DTYPES[q.dtype],
            int(causal), 0 if window is None else int(window),
            0.0 if cap is None else float(cap), float(D) ** -0.5)


def flash_fwd(q, k, v, *, causal: bool, window, cap):
    """``(o (B, S, H, D), lse (B, H, S) float32)`` from the forward
    kernel."""
    check_attention("flash_attention_fwd", q, k, v, window=window, cap=cap)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    check_launch("flash_attention_fwd", _lib().repro_flash_fwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
        *_args(q, k, causal, window, cap), stream_of(q)))
    return o, lse


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, window, cap):
    """``(dq, dk, dv)`` from the backward kernels (one call)."""
    check_attention("flash_attention_bwd", q, k, v, window=window, cap=cap,
                    o=o, lse=lse, do=do)
    B, S, H, _ = q.shape
    G = H // k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    part = None
    if q.dtype == torch.bfloat16 and G > 1:
        part = torch.empty((2, G) + tuple(k.shape), dtype=torch.float32,
                           device=q.device)
    check_launch("flash_attention_bwd", _lib().repro_flash_bwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(delta),
        ptr(dq), ptr(dk), ptr(dv), ptr(part),
        *_args(q, k, causal, window, cap), stream_of(q)))
    return dq, dk, dv
