"""Shared launch plumbing of the ctypes-bound CUDA kernels."""

from __future__ import annotations

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# argtypes shorthands: every pointer and the stream as c_void_p (a plain
# int would be cut to 32 bits), sizes as int64
PTR, I64, INT, F32, F64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_float, ctypes.c_double)


def check_operands(name: str, ref: torch.Tensor, **others) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of ``ref``'s
    device, dtype and shape (the kernels take nothing else)."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: kernel operands must be CUDA tensors")
    if ref.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {ref.dtype}")
    if not ref.is_contiguous():
        raise ValueError(f"{name}: first operand must be contiguous")
    for key, t in others.items():
        if t is None:
            continue
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"want {ref.dtype} on {ref.device}")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def vector_ok(n_inner: int, *tensors) -> bool:
    """Whether 16-byte vector accesses are legal: the inner extent is a
    multiple of the vector and every pointer is 16-byte aligned."""
    per = 16 // tensors[0].element_size()
    return n_inner % per == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card (the getter
    behind ``torch.cuda.current_stream``, without building a Stream
    object: a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t) -> int:
    return None if t is None else t.data_ptr()


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed "
                           f"(cudaGetLastError = {rc})")
