"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source of a kernel suite is compiled by ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout (``build/`` is git-ignored) under a name that carries a hash of
the source, the headers beside it and the flags, so an unchanged source is
compiled once.
Nothing is built when a module is imported: the first launch builds,
and :func:`build_all` compiles several sources in parallel (one ``nvcc``
per source, all started together).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# sm_90a: Hopper.  --fmad=false keeps every float operation separately
# rounded, so the kernels match their plain PyTorch versions bit for bit.
# -Xptxas -v: each kernel's registers and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are compiled at first use")


def library_path(source: Path) -> Path:
    """Where ``source``'s library goes: the name carries a hash of the
    source, of every ``.cuh`` header beside it (which it may include) and
    of the flags, so an edit to any of them builds anew."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path):
    """Start nvcc for ``source`` unless its library exists; returns
    ``(process, tmp, out)`` or None."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job, source: Path) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(sources: Iterable[Path]) -> dict:
    """Compile every source whose library is missing, in parallel;
    returns ``{source: nvcc log}`` of the sources compiled now."""
    sources = list(sources)
    jobs = [(_start(s), s) for s in sources]
    errors, logs = [], {}
    for job, src in jobs:
        if job is None:
            continue
        try:
            logs[src] = _finish(job, src)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def ptxas_summary(log: str) -> list:
    """``(kernel, registers, spill store bytes, spill load bytes)`` per
    entry function of an nvcc ``-Xptxas -v`` log (names as mangled)."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1))) + spills)
            name, spills = None, (0, 0)
    return rows


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, compiling it first if needed."""
    build_all([source])
    return ctypes.CDLL(str(library_path(source)))
