"""Checkpointing: npz leaves + JSON manifest, in the reference's format.

Saves are atomic (tmp-then-rename; see :mod:`repro_torch.checkpoint.io`),
so a run killed mid-save never leaves a torn checkpoint behind.
"""

from repro_torch.checkpoint.io import (  # noqa: F401
    checkpoint_extra,
    checkpoint_step,
    find_latest_checkpoint,
    generator_state,
    is_checkpoint,
    packed_layout_manifest,
    restore_checkpoint,
    save_checkpoint,
    set_generator_state,
)
