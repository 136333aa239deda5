"""Data pipeline: synthetic streams and federated batches (counterpart of
``repro/data``)."""

from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_lm_batch,
    fed_lm_batches,
    make_batch_for,
)
