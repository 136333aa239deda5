"""Checkpointing: flattened npz leaves + JSON key manifest (counterpart of
``repro/checkpoint/io.py``, in the same on-disk format, so that each
package restores the other's checkpoints).

FORMAT.  ``leaves.npz`` holds one array per leaf under the reference's
key: the path of the leaf with its entries joined by ``/``, a NamedTuple
field written ``.name`` (``.x/stages/0/1/attn/wq``, ``.step``), a list
entry by its index and a dict entry by its key.  The port's dotted
parameter names (``stages.0.1.attn.wq``) are paths too, so a
``{name: tensor}`` dict keys as ``stages/0/1/attn/wq``.  A Python int (a
state's ``step`` or round counter ``k``) is a 0-d int32 leaf, a ``None``
field has no leaf and a ``torch.Generator`` is not a leaf (the trainers
keep its state in the manifest's ``extra``, see
:func:`generator_state`).  An async state's carriers are ``.y_tag``
(shaped like ``.x``) and ``.staleness`` (``(A,)`` int32), the keys the
reference's ``_flatten`` gives those fields.  ``manifest.json`` holds the sorted keys, the
step and the optional ``extra`` dict.

BFLOAT16.  numpy has no bfloat16: the reference's ``np.savez`` writes an
ml_dtypes bfloat16 leaf as ``|V2``, two raw bytes.  The port writes its
bfloat16 leaves the same way (the bits through a ``uint16`` view), and
restores a ``|V2`` leaf into a bfloat16 target by its bits (into another
dtype, from the bfloat16 value).  No ml_dtypes is needed.

PACKED STATES.  A packed state is ONE ``(A, width)`` buffer per variable,
and the two packages lay it out differently: the reference flattens the
parameter tree in JAX's order (dict keys sorted, lists in order), puts
the leaves one after the other and pads only the total width to 128;
the port keeps module-registration order and starts every segment at a
multiple of 64 (:mod:`repro_torch.fed.compress`).  Given the port's
``packed_meta``, :func:`save_checkpoint` writes a state's ``x``, ``z``,
``t`` and (async rounds) ``y_tag`` in the reference's columns and
:func:`restore_checkpoint` reads them back into the port's
(:func:`reference_layout` is the port's own copy of the reference's
rule), so one file means the same thing in both packages.  A single-leaf state (the dense ``(N, n)`` front end) is the
array itself in both.

SHARDED STATES.  Under a mesh (:mod:`repro_torch.fed.sharding`) each
rank holds a block of the state: its agent rows and, under a model axis,
its columns of every packed buffer.  The trainers gather the blocks and
rank 0 writes the file the unsharded run writes for the same state.
:func:`restore_checkpoint` with ``shardings=`` reads the global leaves on
every rank and keeps ``shardings(key, leaf)``, its own block (the
reference's ``restore_checkpoint(shardings=)``, which puts the restored
tree on the mesh).

CRASH SAFETY.  :func:`save_checkpoint` is atomic at the directory level:
the checkpoint is assembled in a same-filesystem temporary sibling
(``<name>.ckpt-tmp-*``) -- leaves first, the manifest last, fsync'd -- and
only then renamed over the target.  A process killed at ANY point leaves
either the previous complete checkpoint or the new one at ``path``; the
worst case is a leftover ``*.ckpt-tmp-*`` directory, which
:func:`find_latest_checkpoint` ignores.  The manifest is the commit
record: :func:`is_checkpoint` treats a directory without a parseable
manifest and leaves file as not-a-checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

# the reference's lane width: its packed buffers pad the total width to it
_LANE = 128
# NamedTuple fields that hold a packed (A, width) buffer under packed_meta
PACKED_FIELDS = ("x", "z", "t", "y_tag")


# ---------------------------------------------------------------------------
# The reference's packed column layout
# ---------------------------------------------------------------------------

def _reference_sort_key(name: str) -> tuple:
    """JAX's flattening order of the reference's parameter tree: ``stages``
    is a list (its entries in index order), every other node a dict (its
    keys sorted as strings)."""
    parts = name.split(".")
    return tuple(int(p) if i and parts[i - 1] == "stages" else p
                 for i, p in enumerate(parts))


def reference_layout(meta):
    """The reference's packed layout of the tree that the port's
    ``meta`` describes: ``(order, segments, width)``, ``order`` the port's
    leaf indices in the reference's leaf order, ``segments`` their
    contiguous ``(start, stop)`` columns in that order and ``width`` the
    total padded to 128 (unpadded for a single leaf)."""
    names = pytree.tree_unflatten(list(range(len(meta.shapes))),
                                  meta.treedef)
    if not isinstance(names, dict):
        raise TypeError("reference_layout needs a {name: leaf} tree")
    order = [names[n] for n in sorted(names, key=_reference_sort_key)]
    segments, start = [], 0
    for j in order:
        s0, s1 = meta.segments[j]
        segments.append((start, start + s1 - s0))
        start += s1 - s0
    width = start if len(order) == 1 else -(-start // _LANE) * _LANE
    return order, segments, width


def to_reference_packed(buf: torch.Tensor, meta) -> torch.Tensor:
    """A port-packed ``(A, width)`` buffer in the reference's columns."""
    order, segments, width = reference_layout(meta)
    out = torch.zeros((buf.shape[0], width), dtype=buf.dtype,
                      device=buf.device)
    for j, (r0, r1) in zip(order, segments):
        s0, s1 = meta.segments[j]
        out[:, r0:r1] = buf[:, s0:s1]
    return out


def from_reference_packed(arr: torch.Tensor, meta) -> torch.Tensor:
    """Inverse of :func:`to_reference_packed` (padding columns zero)."""
    order, segments, _ = reference_layout(meta)
    out = torch.zeros((arr.shape[0], meta.width), dtype=arr.dtype,
                      device=arr.device)
    for j, (r0, r1) in zip(order, segments):
        s0, s1 = meta.segments[j]
        out[:, s0:s1] = arr[:, r0:r1]
    return out


def packed_layout_manifest(meta) -> dict:
    """JSON form of a packed layout for the checkpoint manifest, as the
    reference writes it for the same model: the reference's columns (the
    layout the checkpoint holds), its segments and its leaves' shapes in
    its order."""
    order, segments, width = reference_layout(meta)
    return {"state_layout": "packed", "width": int(width),
            "segments": [[int(a), int(b)] for a, b in segments],
            "shapes": [list(map(int, meta.shapes[j])) for j in order]}


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _join(prefix: str, entry: str) -> str:
    return entry if not prefix else f"{prefix}/{entry}"


def _items(tree, prefix: str):
    """``(key, child, field)`` of each child of a node (``field`` names a
    NamedTuple field, else None)."""
    if _is_namedtuple(tree):
        return [(_join(prefix, "." + f), v, f)
                for f, v in zip(tree._fields, tree)]
    if isinstance(tree, dict):
        return [(_join(prefix, str(k).replace(".", "/")), v, None)
                for k, v in tree.items()]
    return [(_join(prefix, str(i)), v, None) for i, v in enumerate(tree)]


def _is_leaf(v) -> bool:
    return isinstance(v, torch.Tensor) or (
        isinstance(v, int) and not isinstance(v, bool))


def _map_leaves(tree, packed_meta, fn, prefix=""):
    """``tree`` with every leaf replaced by ``fn(key, leaf, packed)``
    (``packed``: the leaf is a packed buffer of ``packed_meta``); ``None``
    and ``torch.Generator`` fields stay as they are."""
    if _is_leaf(tree):
        return fn(prefix, tree, False)
    out = []
    for key, v, field in _items(tree, prefix):
        if v is None or isinstance(v, torch.Generator):
            out.append(v)
        elif _is_leaf(v):
            packed = (packed_meta is not None and field in PACKED_FIELDS
                      and isinstance(v, torch.Tensor))
            out.append(fn(key, v, packed))
        else:
            out.append(_map_leaves(v, packed_meta, fn, key))
    if _is_namedtuple(tree):
        return type(tree)(*out)
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    return type(tree)(out)


def _leaves(tree, packed_meta) -> dict:
    """``{key: (leaf, packed)}`` of every leaf of ``tree``."""
    out = {}
    _map_leaves(tree, packed_meta,
                lambda key, leaf, packed: out.setdefault(key, (leaf, packed)))
    return out


def _to_numpy(leaf, packed, packed_meta) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    if packed:
        leaf = to_reference_packed(leaf, packed_meta)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the bits as two raw bytes, ml_dtypes' bfloat16 on disk
        return t.view(torch.uint16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, like):
    """``arr`` as ``like``'s type: an int, or a tensor of ``like``'s dtype
    (on the CPU)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return int(t) if isinstance(like, int) else t.to(like.dtype)


def _disk_shape(leaf, packed, packed_meta) -> tuple:
    if isinstance(leaf, int):
        return ()
    if packed:
        return (leaf.shape[0], reference_layout(packed_meta)[2])
    return tuple(leaf.shape)


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (makes the rename durable; some
    filesystems don't support opening directories -- ignore those)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, tree, step: int | None = None,
                    extra: dict | None = None, packed_meta=None):
    """Write ``tree`` (a state NamedTuple, a ``{name: tensor}`` dict, or
    any nesting of those, lists and tensors) to ``path``.  ``extra`` is an
    optional JSON-able dict stored in the manifest.  ``packed_meta`` is
    the port's layout of the packed ``x`` / ``z`` / ``t`` / ``y_tag``
    buffers of a state, which go to disk in the reference's columns.

    Atomic: assembled in a temporary sibling and renamed into place
    (see the module docstring); a kill mid-save never corrupts an
    existing checkpoint at ``path``.
    """
    path = path.rstrip(os.sep)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(path)
    # same-directory tmp so the final rename never crosses a filesystem
    tmp = tempfile.mkdtemp(prefix=base + ".ckpt-tmp-", dir=parent)
    try:
        flat = {key: _to_numpy(leaf, packed, packed_meta)
                for key, (leaf, packed) in _leaves(tree, packed_meta).items()}
        np.savez(os.path.join(tmp, "leaves.npz"), **flat)
        manifest = {"keys": sorted(flat), "step": step,
                    "treedef": f"repro_torch {type(tree).__name__}"}
        if extra is not None:
            manifest["extra"] = extra
        # the manifest is written LAST and fsync'd: its presence is the
        # commit record (is_checkpoint requires it to parse)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            # swap: move the old checkpoint aside, promote the new one,
            # then drop the old; a failure mid-swap restores the old
            # checkpoint at ``path``
            trash = tempfile.mkdtemp(prefix=base + ".ckpt-tmp-old-",
                                     dir=parent)
            old = os.path.join(trash, "old")
            os.rename(path, old)
            try:
                os.rename(tmp, path)
            except OSError:
                os.rename(old, path)
                raise
            finally:
                shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, path)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_checkpoint(path: str, like, device=None, packed_meta=None,
                       shardings=None):
    """Restore into the structure of ``like`` (a state NamedTuple, a
    ``{name: tensor}`` dict, ...), each leaf with ``like``'s dtype, on
    ``device`` (default: each leaf's own device).  A NamedTuple's
    ``None`` and ``torch.Generator`` fields are carried over from
    ``like``; an int leaf comes back an int.  ``packed_meta`` as in
    :func:`save_checkpoint`.  With ``shardings`` each tensor leaf is read
    whole and ``shardings(key, leaf)`` kept -- this rank's block, whose
    shape must be ``like``'s; ``shardings`` raises a ValueError where the
    file's global leaf does not fit the mesh (another agent count).

    The stored key set is validated against ``like`` up front: missing
    and unexpected leaf keys are reported together in ONE ValueError,
    so a layout/model mismatch reads as a diff instead of a KeyError
    on whichever leaf happened to flatten first."""
    with np.load(os.path.join(path, "leaves.npz")) as data:
        want = _leaves(like, packed_meta)
        have = set(data.files)
        missing = sorted(set(want) - have)
        extra_keys = sorted(have - set(want))
        if missing or extra_keys:
            parts = []
            if missing:
                parts.append("missing from checkpoint: "
                             + ", ".join(missing))
            if extra_keys:
                parts.append("unexpected in checkpoint: "
                             + ", ".join(extra_keys))
            raise ValueError(
                f"checkpoint at {path!r} does not match the restore "
                f"target ({'; '.join(parts)})")

        def load(key, leaf, packed):
            arr = data[key]
            shape = _disk_shape(leaf, packed, packed_meta)
            # under ``shardings`` ``leaf`` is this rank's block: the file's
            # rows (and a dense state's columns) are ``shardings``' to
            # check, a packed buffer's columns are checked here
            lo = 0 if shardings is None else 1
            if (shardings is None or packed) and (
                    arr.ndim != len(shape) or arr.shape[lo:] != shape[lo:]):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {shape}")
            out = _from_numpy(arr, leaf)
            if isinstance(out, int):
                return out
            if packed:
                out = from_reference_packed(out, packed_meta)
            if shardings is not None:
                out = shardings(key, out).contiguous()
                if tuple(out.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: this rank's block of "
                        f"{arr.shape} is {tuple(out.shape)}, want "
                        f"{tuple(leaf.shape)}")
            return out.to(leaf.device if device is None else device)

        return _map_leaves(like, packed_meta, load)


def generator_state(generator: torch.Generator) -> list:
    """A generator's state as a list of ints (JSON for a manifest's
    ``extra``)."""
    return generator.get_state().tolist()


def set_generator_state(generator: torch.Generator, state: list) -> None:
    """Inverse of :func:`generator_state`."""
    generator.set_state(torch.tensor(state, dtype=torch.uint8))


def checkpoint_step(path: str) -> int | None:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("step")


def checkpoint_extra(path: str) -> dict | None:
    """The manifest's ``extra`` dict (None for checkpoints written
    without one)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("extra")


def is_checkpoint(path: str) -> bool:
    """True iff ``path`` holds a COMMITTED checkpoint: a parseable
    manifest plus the leaves file (a torn or in-flight tmp directory
    fails this)."""
    if not os.path.isdir(path):
        return False
    if not os.path.exists(os.path.join(path, "leaves.npz")):
        return False
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    return True


def find_latest_checkpoint(root: str) -> str | None:
    """The newest committed checkpoint directory under ``root``.

    "Newest" = highest manifest ``step`` (name as tie-break, so
    zero-padded ``step-%06d`` names order correctly even without
    steps).  In-flight / leftover ``*.ckpt-tmp-*`` directories and
    anything failing :func:`is_checkpoint` are skipped.  ``root``
    itself qualifies when it is directly a checkpoint."""
    if is_checkpoint(root):
        return root
    if not os.path.isdir(root):
        return None
    best = None
    for name in sorted(os.listdir(root)):
        if ".ckpt-tmp-" in name:
            continue
        cand = os.path.join(root, name)
        if not is_checkpoint(cand):
            continue
        step = checkpoint_step(cand)
        key = (step if step is not None else -1, name)
        if best is None or key > best[0]:
            best = (key, cand)
    return None if best is None else best[1]
