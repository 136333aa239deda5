"""PyTorch port of the Fed-PLT model-scale trainer (``repro`` is the JAX
reference it is held against).

Entry points run on CUDA unless the caller asks for the CPU: a CUDA
request on a machine without a card raises instead of carrying on on the
CPU.  The kernels under :mod:`repro_torch.kernels` launch only on CUDA
tensors; CPU tensors take their plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names
    the CPU (or ``meta``: shapes and dtypes only, nothing allocated, as
    the dry run describes inputs).  Raises when CUDA is asked for
    (explicitly or by default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or "
                         f"meta)")
    return dev
